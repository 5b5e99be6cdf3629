"""The port's serving runtime and index checkpoints (``repro_torch.serving``)
against the JAX package's, on the CPU.

One small reference index per backbone (DSTree, iSAX; ``isax_config``'s
settings), carried across with its calibration split and, after the
reference's config and build report are copied onto it, held to the
reference:

* **Index checkpoints, both ways.** The reference's ``save_index`` loads in
  the port's ``load_index(device="cpu")`` and the port's in the
  reference's: the same manifest (paths, keys, dtypes, shapes), the same
  metadata (``tree.msgpack`` byte for byte), every array bitwise.  Search
  on a loaded index equals search on the index it came from bitwise
  within a package, and across the packages to the port's tolerance of
  ``test_torch_isax.py`` (ids and counters exact, distances rtol = atol =
  1e-5).  An int8 index round-trips both ways; bfloat16 weights are
  refused by both packages with the same message.
* **Serving parity.** On one seeded trace (``poisson_trace`` gives the
  same requests in both packages) under one injected ``service_time``,
  cold and with warm start, both packages' sessions (shadow rate 0.5) give
  equal batch logs (host keys stripped) and latencies, per request equal
  ``searched`` and the top-1 distance within rtol 1e-5 / atol 1e-6, equal
  telemetry snapshots once the ``wall`` subtree is masked, and equal
  shadow reports (rids, recalls, miss ids, leaves and bound labels;
  distances within rtol = atol = 1e-5); ``explain_query`` gives the same
  leaf verdicts and cascade counts.
* The port's pipelined serving equals its serial serving with ``==``
  (``tests/test_serving.py:382`` for the reference), and the reference's
  batcher, pipeline, warm-start cache and telemetry unit tests that need
  no index run against the port's modules.
"""
import dataclasses
import os

import msgpack
import numpy as np
import pytest
import torch

from repro import serving as ref_serving
from repro.core import build, engine, filter_training, filters
from repro_torch import serving as port_serving
from repro_torch.core import build as t_build
from repro_torch.core import engine as t_engine
from repro_torch.serving import session as port_session
from test_torch_isax import carry, isax_config, target
from _torch_threads import one_torch_thread  # noqa: F401

HOST_KEYS = ("wall", "dispatch_s", "harvest_s", "t_disp", "t_done")
#: the parity tests' engine strategy and largest bucket: the reference's
#: scan compiles one program per (bucket, k), its compact strategy one per
#: survivor bucket too, which would make these tests several times slower;
#: the port's compact strategy is held to the reference's in
#: ``test_torch_isax.py``, ``test_torch_engine.py`` and the pipelined test
#: below runs it
STRATEGY = "scan"
BUCKET = 4


#: the pairs built so far, by backbone: a DSTree-only test shares the
#: parametrised tests' DSTree build
_PAIRS: dict = {}


def _pair(backbone, randwalk_small):
    """(reference index, the port's carried index with the reference's
    config and build report), built once per backbone."""
    if backbone not in _PAIRS:
        cfg = dataclasses.replace(isax_config(build, filter_training),
                                  backbone=backbone)
        ref = build.build_leafi(randwalk_small[:1500], cfg)
        port = carry(ref, with_calib=True)
        port = dataclasses.replace(
            port, config=t_build.LeaFiConfig(**{
                f: getattr(ref.config, f)
                for f in port_session._CONFIG_FIELDS}),
            build_report=dict(ref.build_report))
        _PAIRS[backbone] = ref, port
    return _PAIRS[backbone]


@pytest.fixture(scope="module", params=["dstree", "isax"])
def pair(request, randwalk_small):
    """Each backbone's (reference index, carried port index)."""
    return _pair(request.param, randwalk_small)


@pytest.fixture(scope="module")
def dstree_pair(randwalk_small):
    """The DSTree (reference index, carried port index), for the tests
    that do not depend on the backbone."""
    return _pair("dstree", randwalk_small)


def _manifest(path):
    with open(os.path.join(path, "tree.msgpack"), "rb") as f:
        blob = f.read()
    return blob, msgpack.unpackb(blob, raw=False)


def _arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def _assert_bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _port_arrays(lfi):
    """The port index's arrays by checkpoint path, as numpy."""
    idx = lfi.index
    out = {f"['{n}']": getattr(idx, n).numpy()
           for n in ("series", "order", "leaf_start", "leaf_size")}
    out.update({f"['payload']/['{k}']": v.numpy()
                for k, v in idx.payload.items()})
    out.update({f"['filter_params']/['{k}']": v.numpy()
                for k, v in lfi.filter_params.items()})
    out["['leaf_ids']"] = np.asarray(lfi.leaf_ids)
    out.update({f"['tuner']/['{k}']": np.asarray(getattr(lfi.tuner, k))
                for k in ("knots_q", "knots_o", "slopes", "max_offset")})
    out.update({f"['calib']/['{k}']": getattr(lfi.calib, k).numpy()
                for k in ("queries", "d_lb", "d_L")})
    return out


def _assert_loaded_equals(loaded, port):
    """A loaded port index holds ``port``'s arrays bitwise (the leaf layout
    widened back to int64), its config and its build report."""
    want, got = _port_arrays(port), _port_arrays(loaded)
    assert set(got) == set(want)
    for k in want:
        _assert_bitwise(got[k], want[k], k)
    assert loaded.index.order.dtype == torch.int64
    assert loaded.index.device.type == "cpu"
    for f in port_session._CONFIG_FIELDS:
        assert getattr(loaded.config, f) == getattr(port.config, f), f
    assert loaded.build_report == port.build_report
    assert (loaded.index.kind, loaded.index.max_leaf_size,
            loaded.index.n_series, loaded.index.length) == \
        (port.index.kind, port.index.max_leaf_size, port.index.n_series,
         port.index.length)


def _assert_same_result(a, b, bitwise=True):
    fields = ("ids", "searched", "pruned_lb", "pruned_filter", "computed")
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    if bitwise:
        _assert_bitwise(a.dists, b.dists, "dists")
    else:
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-5, atol=1e-5)


def test_checkpoints_go_both_ways(pair, tmp_path):
    """Same manifest and metadata bytes, every array bitwise, each package
    loading the other's."""
    ref, port = pair
    rp, pp = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_serving.save_index(rp, ref)
    port_serving.save_index(pp, port)
    ref_blob, ref_meta = _manifest(rp)
    port_blob, port_meta = _manifest(pp)
    # the reference's dtypes, read off its own checkpoint: the leaf layout
    # is int32 there, int64 in the port
    dtypes = {e["path"]: e["dtype"] for e in ref_meta["manifest"]}
    assert dtypes["['order']"] == dtypes["['leaf_start']"] == "int32"
    assert port_meta == ref_meta
    assert port_blob == ref_blob
    ref_arrays, port_arrays = _arrays(rp), _arrays(pp)
    assert set(ref_arrays) == set(port_arrays)
    for k in ref_arrays:
        _assert_bitwise(port_arrays[k], ref_arrays[k], k)
    # the reference's checkpoint in the port
    _assert_loaded_equals(port_serving.load_index(rp, device="cpu"), port)
    # the port's checkpoint in the reference
    back = ref_serving.load_index(pp)
    for name in ("series", "order", "leaf_start", "leaf_size"):
        _assert_bitwise(getattr(back.index, name),
                        getattr(ref.index, name), name)
    for k, v in ref.index.payload.items():
        _assert_bitwise(back.index.payload[k], v, k)
    for k, v in ref.filter_params.items():
        _assert_bitwise(back.filter_params[k], v, k)
    for k in ("knots_q", "knots_o", "slopes", "max_offset"):
        _assert_bitwise(getattr(back.tuner, k), getattr(ref.tuner, k), k)
    for k in ("queries", "d_lb", "d_L"):
        _assert_bitwise(getattr(back.calib, k), getattr(ref.calib, k), k)
    assert back.config == dataclasses.replace(
        ref.config, train=back.config.train)
    assert back.build_report == ref.build_report


def test_loaded_indexes_answer_as_their_sources(pair, queries_small,
                                                tmp_path):
    """Per-query targets, k = 5: a loaded index answers bitwise as the
    index it came from in the same package; across packages to the
    port's tolerance."""
    ref, port = pair
    rp, pp = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_serving.save_index(rp, ref)
    port_serving.save_index(pp, port)
    qt_all = target("per-query", len(queries_small))
    q, qt = queries_small[:BUCKET], qt_all[:BUCKET]
    kw = dict(k=5, quality_target=qt, strategy=STRATEGY)
    port_from_ref = port_serving.load_index(rp, device="cpu")
    for strategy in ("compact", STRATEGY):
        want = port.search(queries_small, k=5, quality_target=qt_all,
                           strategy=strategy, device="cpu")
        got = port_from_ref.search(queries_small, k=5, quality_target=qt_all,
                                   strategy=strategy, device="cpu")
        _assert_same_result(got, want)
    ref_from_port = ref_serving.load_index(pp)
    _assert_same_result(ref_from_port.search(q, **kw), ref.search(q, **kw))
    got = port_from_ref.search(q, device="cpu", **kw)
    _assert_same_result(got, ref.search(q, **kw), bitwise=False)


def _int8(ref):
    """The reference's index with int8 weights (its ``quantize_mlp``; the
    tuner kept, which a round trip does not read), and carried across."""
    ref8 = dataclasses.replace(
        ref, filter_params=filters.quantize_mlp(ref.filter_params, "int8"),
        config=dataclasses.replace(ref.config, weight_dtype="int8"))
    port8 = carry(ref8, with_calib=True)
    port8 = dataclasses.replace(port8, config=t_build.LeaFiConfig(**{
        f: getattr(ref8.config, f) for f in port_session._CONFIG_FIELDS}),
        build_report=dict(ref8.build_report))
    return ref8, port8


def test_int8_index_round_trips_and_bf16_is_refused(pair, tmp_path,
                                                    queries_small):
    ref, _ = pair
    ref8, port8 = _int8(ref)
    rp, pp = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_serving.save_index(rp, ref8)
    port_serving.save_index(pp, port8)
    assert _manifest(pp) == _manifest(rp)
    dtypes = {e["path"]: e["dtype"] for e in _manifest(rp)[1]["manifest"]}
    assert dtypes["['filter_params']/['w1']"] == "int8"
    ref_arrays, port_arrays = _arrays(rp), _arrays(pp)
    for k in ref_arrays:
        _assert_bitwise(port_arrays[k], ref_arrays[k], k)
    loaded = port_serving.load_index(rp, device="cpu")
    _assert_loaded_equals(loaded, port8)
    assert loaded.config.weight_dtype == "int8"
    _assert_same_result(
        loaded.search(queries_small, k=1, quality_target=0.95, device="cpu"),
        port8.search(queries_small, k=1, quality_target=0.95, device="cpu"))
    back = ref_serving.load_index(pp)
    for k, v in ref8.filter_params.items():
        _assert_bitwise(back.filter_params[k], v, k)
    assert back.config.weight_dtype == "int8"
    # bfloat16 weights: refused by both, with the same message
    ref16 = dataclasses.replace(ref, filter_params=dict(
        ref.filter_params, w1=ref.filter_params["w1"].astype("bfloat16")))
    with pytest.raises(ValueError, match="bfloat16") as want:
        ref_serving.save_index(str(tmp_path / "ref16"), ref16)
    port16 = t_build.requantize_leafi(port8, "bfloat16", device="cpu")
    with pytest.raises(ValueError, match="bfloat16") as got:
        port_serving.save_index(str(tmp_path / "port16"), port16)
    assert str(got.value) == str(want.value)
    assert not os.path.exists(str(tmp_path / "port16"))


# ---------------------------------------------------------------------------
# serving parity
# ---------------------------------------------------------------------------


def _trace(pkg, queries, n=32, seed=9, ks=(1, 5)):
    return pkg.poisson_trace(queries, rate=900.0, n_requests=n,
                             targets=(0.8, 0.95), ks=ks, seed=seed)


def _serve(pkg, lfi, trace, *, warm, oracle=None, pipeline=0,
           strategy="compact", bucket=BUCKET, **kw):
    if pkg is port_serving:
        kw["device"] = "cpu"
    session = pkg.ServingSession(lfi, strategy=strategy, warm_start=warm,
                                 **kw)
    report = session.serve(trace, batcher=pkg.MicroBatcher(
        max_batch=bucket, max_wait=0.004), recall_oracle=oracle,
        service_time=lambda b: 1e-3 * max(b.bucket / bucket, 0.25),
        pipeline=pipeline)
    return session, report


def _oracle(ref, queries, trace):
    """rid → the exact 1-NN distance of its pool row, by brute force."""
    S = np.asarray(ref.index.series[:ref.index.n_series], np.float64)
    d = np.sqrt(((queries[:, None, :] - S[None]) ** 2).sum(-1)).min(1)
    return {r.rid: float(np.float32(d[r.pool_row])) for r in trace}


def _strip(log):
    return [{k: v for k, v in b.items() if k not in HOST_KEYS} for b in log]


def _masked(snapshot):
    return {k: v for k, v in snapshot.items() if k != "wall"}


def test_poisson_trace_is_the_references(queries_small):
    a = _trace(ref_serving, queries_small, n=200, seed=3)
    b = _trace(port_serving, queries_small, n=200, seed=3)
    assert [(r.rid, r.arrival, r.k, r.quality_target, r.pool_row)
            for r in a] == [(r.rid, r.arrival, r.k, r.quality_target,
                             r.pool_row) for r in b]
    for x, y in zip(a, b):
        _assert_bitwise(x.query, y.query, x.rid)


def _assert_served_alike(pr, rr, n):
    """Equal batch logs (host keys stripped), latencies, ``searched`` and
    recall groups; each top-1 distance within rtol 1e-5 / atol 1e-6."""
    assert pr["n_requests"] == rr["n_requests"] == n
    assert _strip(pr["batches"]) == _strip(rr["batches"])
    for rid, want in rr["completions"].items():
        got = pr["completions"][rid]
        assert got["latency"] == want["latency"], rid
        assert got["result"]["searched"] == want["result"]["searched"], rid
        np.testing.assert_allclose(got["result"]["dist"],
                                   want["result"]["dist"], rtol=1e-5,
                                   atol=1e-6, err_msg=str(rid))
    assert pr["recall_by_target"] == rr["recall_by_target"]


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_serving_matches_the_reference(pair, queries_small, warm):
    ref, port = pair
    trace = _trace(ref_serving, queries_small)
    oracle = _oracle(ref, queries_small, trace)
    kw = dict(warm=warm, oracle=oracle, shadow_rate=0.5,
              strategy=STRATEGY)
    rs, rr = _serve(ref_serving, ref, trace, **kw)
    ps, pr = _serve(port_serving, port, _trace(port_serving, queries_small),
                    **kw)
    _assert_served_alike(pr, rr, len(trace))
    assert _masked(ps.telemetry.snapshot()) == \
        _masked(rs.telemetry.snapshot())
    # the shadow audits: the same requests, recalls and misses
    rsh, psh = rr["shadow"], pr["shadow"]
    assert psh["n_shadowed"] == rsh["n_shadowed"] > 0
    assert psh["per_query"] == rsh["per_query"]
    keys = ("rid", "id", "rank", "leaf", "bound", "target")
    assert [{k: m[k] for k in keys} for m in psh["misses"]] == \
        [{k: m[k] for k in keys} for m in rsh["misses"]]
    for a, b in zip(psh["misses"], rsh["misses"]):
        np.testing.assert_allclose(
            [a["dist"], a["d_lb"], a["d_F"], a["served_kth"]],
            [b["dist"], b["d_lb"], b["d_F"], b["served_kth"]],
            rtol=1e-5, atol=1e-5)
    assert ps.shadow.summary() == rs.shadow.summary()


def test_compact_warm_serving_matches_the_reference(dstree_pair,
                                                   queries_small):
    """The served default, whole: the compact strategy with per-query
    targets and the warm bound, on a few k = 5 requests at bucket 2
    (DSTree; the reference compiles a program per survivor bucket, so the
    trace is short).  Held as the scan parity above: equal batch logs, latencies,
    ``searched``, recall groups and telemetry (``wall`` masked), top-1
    distances within rtol 1e-5 / atol 1e-6."""
    ref, port = dstree_pair
    trace = _trace(ref_serving, queries_small, n=8, ks=(5,))
    oracle = _oracle(ref, queries_small, trace)
    kw = dict(warm=True, oracle=oracle, strategy="compact", bucket=2)
    rs, rr = _serve(ref_serving, ref, trace, **kw)
    ps, pr = _serve(port_serving, port,
                    _trace(port_serving, queries_small, n=8, ks=(5,)), **kw)
    assert any(b["n_valid"] == 2 for b in pr["batches"])
    _assert_served_alike(pr, rr, len(trace))
    assert _masked(ps.telemetry.snapshot()) == \
        _masked(rs.telemetry.snapshot())


def test_explain_query_gives_the_references_verdicts(pair, queries_small):
    ref, port = pair
    rs = ref_serving.ServingSession(ref, strategy=STRATEGY)
    ps = port_serving.ServingSession(port, strategy=STRATEGY, device="cpu")
    for i, (k, t) in enumerate(((1, 0.8), (5, 0.95))):
        want = ref_serving.explain_query(rs, queries_small[i], target=t,
                                         k=k, rid=i)
        got = port_serving.explain_query(ps, queries_small[i], target=t,
                                         k=k, rid=i)
        assert got["cascade"] == want["cascade"]
        assert got["served"]["ids"] == want["served"]["ids"]
        assert [(r["leaf"], r["verdict"]) for r in got["leaves"]] == \
            [(r["leaf"], r["verdict"]) for r in want["leaves"]]
        np.testing.assert_allclose([r["d_lb"] for r in got["leaves"]],
                                   [r["d_lb"] for r in want["leaves"]],
                                   rtol=1e-5, atol=1e-5)
        assert got["shadow"]["true_ids"] == want["shadow"]["true_ids"]
        assert got["shadow"]["recall"] == want["shadow"]["recall"]
        assert [m["leaf"] for m in got["shadow"]["misses"]] == \
            [m["leaf"] for m in want["shadow"]["misses"]]


def test_shadow_helpers_are_the_references(pair, queries_small):
    """``sample_mask`` and ``leaf_of_ids`` exactly, ``_bound_rows`` within
    rtol = atol = 1e-5 (the same infinities), ``attribute_misses`` on
    crafted rows (each bound label, a warm seed, ties at the served k-th
    distance) exactly."""
    from repro.serving import shadow as ref_shadow
    from repro_torch.serving import shadow as port_shadow
    ref, port = pair
    rids = np.arange(1000)
    for rate, seed in ((0.05, 0), (0.5, 3), (1.0, 1), (0.0, 0)):
        np.testing.assert_array_equal(
            port_shadow.sample_mask(rids, rate, seed),
            ref_shadow.sample_mask(rids, rate, seed))
    ids = np.random.default_rng(0).integers(0, ref.index.n_series, 64)
    np.testing.assert_array_equal(port_shadow.leaf_of_ids(port.index, ids),
                                  ref_shadow.leaf_of_ids(ref.index, ids))
    q, t = queries_small[:5], np.array([0.8, 0.95, 0.99, 0.9, 0.95])
    for targets in (t, None):
        want = ref_shadow._bound_rows(ref, q, targets)
        got = port_shadow._bound_rows(port, q, targets, torch.device("cpu"))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    leaf_of = np.array([0, 1, 2, 3, 4])
    true_d = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    served = np.array([1.0, 2.0, 3.5, 4.5, 6.0], np.float32)
    d_lb = np.array([0.5, 7.0, 2.0, 6.5, 0.0, 0.0], np.float32)
    labels = set()
    for d_F, ub in ((np.array([0.0, 0.0, 9.0, -np.inf, 1.0, 0.0]), np.inf),
                    (np.array([0.0, 0.0, 0.0, 0.0, 9.0, 0.0]), 1.5)):
        d_F = d_F.astype(np.float32)
        want = ref_shadow.attribute_misses(served, np.arange(5), true_d,
                                           np.arange(5) + 10, d_lb, d_F, ub,
                                           leaf_of)
        got = port_shadow.attribute_misses(served, np.arange(5), true_d,
                                           np.arange(5) + 10, d_lb, d_F, ub,
                                           leaf_of)
        assert got == want
        labels |= {m["bound"] for m in got[1]}
    assert labels == {"box", "seed", "filter", "timing"}


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_pipelined_serving_equals_serial(pair, queries_small, warm):
    """The reference's determinism pin (``tests/test_serving.py:382``) on
    the port: the same batch log, completion times and results, compared
    with ``==``; the pipelined log carries its overlap accounting."""
    _, port = pair
    trace = _trace(port_serving, queries_small, n=64)
    _, r0 = _serve(port_serving, port, trace, warm=warm)
    _, r1 = _serve(port_serving, port, trace, warm=warm, pipeline=1)
    _, r2 = _serve(port_serving, port, trace, warm=warm, pipeline=2)
    for r in (r1, r2):
        assert _strip(r0["batches"]) == _strip(r["batches"])
        for rid in r0["completions"]:
            c0, c1 = r0["completions"][rid], r["completions"][rid]
            assert c0["latency"] == c1["latency"], rid
            assert c0["result"] == c1["result"], rid
        assert all(b["harvest_s"] is not None for b in r["batches"])
        assert all(b["t_done"] >= b["t_disp"] for b in r["batches"])


def test_session_warmup_search_and_telemetry(pair, queries_small):
    """``warmup`` counts its (bucket, k) shapes once; ``search`` feeds the
    telemetry; the suggested survivor capacity covers the observed counts;
    the phases land in the summary after a pipelined warm trace."""
    _, port = pair
    session = port_serving.ServingSession(port, device="cpu")
    assert session.warmup(max_batch=4, ks=(1,), queries=queries_small) == 3
    assert session.warmup(max_batch=4, ks=(1,)) == 0
    qt = target("per-query", len(queries_small))
    res = session.search(queries_small, quality_targets=qt, k=1)
    tel = session.telemetry
    assert tel.n_requests == len(queries_small)
    assert 0.0 <= tel.pruning_ratio() <= 1.0
    cap = tel.suggest_max_survivors()
    assert cap >= 1 and cap & (cap - 1) == 0
    surv = np.asarray(res.computed)
    assert (surv > cap).mean() <= 0.01 + 1.0 / len(surv)
    trace = _trace(port_serving, queries_small, n=24)
    s, _ = _serve(port_serving, port, trace, warm=True, pipeline=1)
    phases = s.telemetry.summary()["phases"]
    assert set(phases) == {"queue_wait", "form", "execute"}
    for ph in phases.values():
        assert np.isfinite(ph["p50"]) and ph["p50"] <= ph["p99"]
    assert len(s.telemetry.queue_wait) == 24
    assert len(s.telemetry.form_s) == len(s.telemetry.exec_s)


def test_warm_start_keeps_the_prune_only_contract(pair, queries_small):
    """Warm-started serving never returns a distance below the exact one
    (less 1e-4), and recall stays within 0.05 of cold serving."""
    _, port = pair
    trace = _trace(port_serving, queries_small)
    exact = port.search_exact(queries_small, device="cpu")
    oracle = {r.rid: float(exact.dists[r.pool_row, 0]) for r in trace}
    _, cold = _serve(port_serving, port, trace, warm=False, oracle=oracle)
    _, warm = _serve(port_serving, port, trace, warm=True, oracle=oracle)
    for t, rec in cold["recall_by_target"].items():
        assert warm["recall_by_target"][t]["recall"] >= rec["recall"] - 0.05
    for rid, c in warm["completions"].items():
        assert c["result"]["dist"] >= oracle[rid] - 1e-4


# ---------------------------------------------------------------------------
# the reference's unit tests that need no index, on the port's modules
# (tests/test_serving.py:129-185, :229-290, :331, :447)
# ---------------------------------------------------------------------------


def _toy_trace(rate, n=64, seed=5, ks=(1, 5)):
    pool = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    return port_serving.poisson_trace(pool, rate=rate, n_requests=n,
                                      targets=(0.8, 0.9, 0.99), ks=ks,
                                      seed=seed)


def _drive(trace, max_batch, max_wait, service=1e-3):
    batcher = port_serving.MicroBatcher(max_batch=max_batch,
                                        max_wait=max_wait)
    return port_serving.run_trace(trace, batcher, lambda b: None,
                                  service_time=lambda b: service)


def test_batcher_policy_and_completeness():
    trace = _toy_trace(rate=2000.0)
    completions, batch_log = _drive(trace, max_batch=8, max_wait=0.01)
    assert sorted(completions) == [r.rid for r in trace]
    arrivals = {r.rid: r.arrival for r in trace}
    ks = {r.rid: r.k for r in trace}
    for b in batch_log:
        assert b["bucket"] in (1, 2, 4, 8) and b["n_valid"] <= b["bucket"]
    for k in (1, 5):
        order = [rid for rid in sorted(completions,
                                       key=lambda r: completions[r]["finish"])
                 if ks[rid] == k]
        assert all(arrivals[a] <= arrivals[b] + 1e-12
                   for a, b in zip(order, order[1:]))


def test_batcher_deadline_flush_under_light_load():
    trace = _toy_trace(rate=10.0, n=16, ks=(1,))
    service, max_wait = 1e-3, 0.01
    completions, batch_log = _drive(trace, max_batch=8, max_wait=max_wait,
                                    service=service)
    for b in batch_log:
        assert b["n_valid"] < 8
    for c in completions.values():
        assert c["latency"] <= max_wait + 2 * service + 1e-9
    for finish in {c["finish"] for c in completions.values()}:
        members = [c for c in completions.values() if c["finish"] == finish]
        assert max(m["latency"] for m in members) >= max_wait - 1e-9


def test_batcher_trace_replay_is_deterministic_and_the_references():
    trace = _toy_trace(rate=500.0)
    a_c, a_log = _drive(trace, max_batch=8, max_wait=0.005)
    b_c, b_log = _drive(trace, max_batch=8, max_wait=0.005)
    assert _strip(a_log) == _strip(b_log)
    assert {r: c["latency"] for r, c in a_c.items()} == \
        {r: c["latency"] for r, c in b_c.items()}
    # the reference's batcher and run_trace on the same trace
    pool = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    ref_trace = ref_serving.poisson_trace(pool, rate=500.0, n_requests=64,
                                          targets=(0.8, 0.9, 0.99),
                                          ks=(1, 5), seed=5)
    r_c, r_log = ref_serving.run_trace(
        ref_trace, ref_serving.MicroBatcher(max_batch=8, max_wait=0.005),
        lambda b: None, service_time=lambda b: 1e-3)
    assert _strip(r_log) == _strip(a_log)
    assert {r: c["latency"] for r, c in r_c.items()} == \
        {r: c["latency"] for r, c in a_c.items()}


def test_latency_percentiles_helper():
    p = port_serving.latency_percentiles(np.arange(1, 101))
    assert p["p50"] == pytest.approx(50.5)
    assert p["p99"] == pytest.approx(99.01)
    assert np.isnan(port_serving.latency_percentiles([])["p95"])


def test_tuned_max_survivors_bounds_overflow_and_is_the_references():
    L = 1024
    rng = np.random.default_rng(0)
    calib = rng.lognormal(mean=3.0, sigma=0.8, size=4000).astype(int) + 1
    cap = t_engine.tuned_max_survivors(calib, L, pct=99.0)
    assert 1 <= cap <= 2 * L and cap & (cap - 1) == 0
    fresh = rng.lognormal(mean=3.0, sigma=0.8, size=4000).astype(int) + 1
    assert (fresh > cap).mean() <= 0.02
    assert t_engine.tuned_max_survivors([], L) == \
        t_engine.default_max_survivors(L)
    assert t_engine.tuned_max_survivors([10 * L], L) <= \
        t_engine.tuned_max_survivors([L], L)
    for n_leaves in (1, 7, 8, 9, 1000, 1024, 4096, 7479):
        assert t_engine.default_max_survivors(n_leaves) == \
            engine.default_max_survivors(n_leaves)
        for counts, pct, ms in ((calib, 99.0, 0), (calib[:5], 99.0, 100),
                                ([3, 9, 200], 50.0, 0), ([], 99.0, 0)):
            assert t_engine.tuned_max_survivors(counts, n_leaves, pct, ms) \
                == engine.tuned_max_survivors(counts, n_leaves, pct, ms)


def test_suggest_max_survivors_cold_start_floors_at_default():
    L = 1024
    tel = port_serving.Telemetry()
    tel.n_leaves = L
    tel.survivors.extend([1, 2, 3])
    assert tel.suggest_max_survivors() >= t_engine.default_max_survivors(L)
    tel2 = port_serving.Telemetry()
    tel2.n_leaves = L
    tel2.survivors.extend([4] * 400)
    assert tel2.suggest_max_survivors() == \
        t_engine.tuned_max_survivors(np.full(400, 4), L)
    assert tel2.suggest_max_survivors() < t_engine.default_max_survivors(L)
    assert "phases" not in port_serving.Telemetry().summary()


def test_bsf_cache_bounds_are_valid_and_staged_commits_lag():
    rng = np.random.default_rng(3)
    base = rng.standard_normal((32, 16)).astype(np.float32)
    dists = rng.uniform(1.0, 2.0, 32).astype(np.float32)
    cache = port_serving.BsfCache(capacity=16)
    assert cache.seed(base, 1) is None
    cache.update(base, dists, k=1)
    assert len(cache) == 16
    near = base[-16:] + 0.01 * rng.standard_normal((16, 16)).astype(
        np.float32)
    ub = cache.seed(near, 1)
    assert np.isfinite(ub).all()
    assert (ub >= dists[-16:] - 0.2).all()
    assert cache.seed(near, 5) is None
    # the reference's cache gives the same bound bitwise
    ref_cache = ref_serving.BsfCache(capacity=16)
    ref_cache.update(base, dists, k=1)
    _assert_bitwise(ub, ref_cache.seed(near, 1), "seed")
    cache2 = port_serving.BsfCache()
    cache2.stage(0, base[:4], dists[:4], k=1)
    cache2.stage(1, base[4:8], dists[4:8], k=1)
    assert cache2.seed(base, 1) is None
    cache2.commit_through(0)
    assert len(cache2) == 4
    cache2.commit_through(5)
    assert len(cache2) == 8
    cache3 = port_serving.BsfCache()
    cache3.update(base[:4], np.array([1.0, np.inf, np.nan, 2.0]), k=1)
    assert len(cache3) == 2
    cache3.reset()
    assert len(cache3) == 0 and cache3.seed(base, 1) is None


def test_run_trace_pipelined_requires_service_model():
    trace = _toy_trace(rate=500.0, n=8, ks=(1,))
    with pytest.raises(ValueError, match="service_time"):
        port_serving.run_trace_pipelined(
            trace, port_serving.MicroBatcher(), lambda b: b, lambda h: None,
            service_time=None)
    with pytest.raises(ValueError, match="max_in_flight"):
        port_serving.run_trace_pipelined(
            trace, port_serving.MicroBatcher(), lambda b: b, lambda h: None,
            service_time=lambda b: 1e-3, max_in_flight=0)


def _load_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_merges_the_served_calls():
    """``_merge_serving`` files the serving phase's captured calls under
    ``<key>@serving`` beside the other paths' (which it leaves alone),
    drops the fewest-query entries and adds its ``box_lb`` shapes' launches
    to theirs."""
    smoke = _load_smoke()
    captured = {"replay": (9, "main"), "box_lb@shapes": {(4, 10, 8): (2, "a")}}
    served = {"replay": (1, "r"), "replay@bound": (2, ("r", "ub")),
              "leaf_topk@probe": (3, "p"), "box_lb@min_q": (1, "m"),
              "box_lb@shapes": {(4, 10, 8): (3, "b"), (1, 10, 8): (1, "c")}}
    smoke._merge_serving(captured, served)
    assert captured == {
        "replay": (9, "main"), "replay@serving": (1, "r"),
        "replay@bound@serving": (2, ("r", "ub")),
        "leaf_topk@probe@serving": (3, "p"),
        "box_lb@shapes": {(4, 10, 8): (5, "b"), (1, 10, 8): (1, "c")}}


def test_chip_smoke_counts_every_box_shape_beyond_max_q(monkeypatch):
    """Under ``max_q`` (the serving phase's bucket), a ``box_lb`` call of
    more queries (the launcher's oracle) still counts among the shapes,
    and only a call within it is kept as the kernel's largest."""
    from repro_torch.kernels.box_lb import kernel as box_kernel
    from repro_torch.kernels.box_lb import ref as box_ref
    smoke = _load_smoke()
    monkeypatch.setattr(box_kernel, "box_lb_cuda", box_ref.box_lb)
    rng = np.random.default_rng(0)
    lo = torch.from_numpy(rng.standard_normal((10, 8)).astype(np.float32))
    hi = lo + 1
    captured: dict = {}
    with smoke.capture_largest_inputs(captured, bound=True, max_q=4):
        for n in (4, 16, 4):
            q = torch.from_numpy(rng.standard_normal((n, 8)).astype(
                np.float32))
            box_kernel.box_lb_cuda(q, lo, hi)
    assert {k: v[0] for k, v in captured["box_lb@shapes"].items()} == \
        {(4, 10, 8): 2, (16, 10, 8): 1}
    assert captured["box_lb"][1][0].shape == (4, 8)
    assert captured["box_lb@min_q"][0] == 4


def test_chip_smoke_serving_phase_rehearsal_on_cpu(dstree_pair,
                                                   queries_small,
                                                   tmp_path, capsys):
    """``chip_smoke.run_serving`` as the card runs it, at a tiny size on the
    CPU (where no kernel launches, so nothing is captured): the checkpoint
    round trip, the launcher, the determinism (its exact oracle held to a
    plain float64 scan) and the breakdown.  The phase reads no backbone
    of its own, so DSTree alone, as on the card."""
    smoke = _load_smoke()
    _, port = dstree_pair
    label = f"{port.index.kind} "
    captured: dict = {}
    out = smoke.run_serving(port, queries_small, device="cpu",
                            scratch=str(tmp_path / "scratch"),
                            out_dir=str(tmp_path / "out"), n_requests=48,
                            n_det=48, batch=8, captured=captured,
                            label=label)
    assert not captured
    assert set(out["determinism"]["true_nearest_share"]) == \
        {"0.9", "0.95", "0.99"}
    assert out["report"]["n_requests"] == 48
    assert set(out["launches"]) == set(smoke.KERNELS)
    assert not any(out["launches"].values())
    assert set(out["breakdown"]) == {name for name, _, _ in
                                     smoke.SERVE_CONFIGS} | {"order_copy_ms"}
    assert out["breakdown"]["both"]["seed_ms"] is not None
    assert out["breakdown"]["cold"]["board_ms"] is None
    assert out["checkpoint"]["bytes"] > port.index.series.numel() * 4
    assert os.listdir(tmp_path / "scratch") == []
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        f"serving_{port.index.kind}_{k}" for k in
        ("health.json", "metrics.prom", "trace.json", "main.log"))
    printed = capsys.readouterr().out
    for line in (f"{label}checkpoint round trip:", f"{label}serve.main: ",
                 f"{label}serving determinism: 48 requests",
                 f"{label}serving breakdown [both]",
                 f"launches on the {label}serving path"):
        assert line in printed, line
