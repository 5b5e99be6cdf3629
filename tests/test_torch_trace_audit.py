"""The cascade trace and the per-leaf filter audit through the port's
engine and batched search, with the prune-only bound ``bsf_ub``, against
the JAX package's, on the CPU.

Reference-built DSTree and iSAX trees (and LeaFi indexes, for the search)
are carried across by ``repro_torch.bridge``; the predictions ``d_F`` are
the reference tests' ``_synthetic_predictions`` (``tests/test_obs.py``) on
the reference's lower bounds, so the filter cascade prunes.  On this
tie-free data the ``CascadeTrace`` fields and the integer ``FilterAudit``
fields equal the reference's exactly, on both backbones, both strategies,
``direct`` and ``pairwise``, k = 1 and 5, with and without a bound.  The
float fields (``resid_sum``, ``resid_sumsq``, ``resid_min``) sum float32
distances taken in another order: each is held within rtol 1e-5 of the
field's largest value.  Inside the port, trace and audit on or off give
bitwise the same answers and counters, and a valid bound leaves exact
answers bitwise as they are while searching no more leaves (under
``pairwise`` the bound shrinks the survivors' union, and with it the
shapes of the union's matrix products: the ids stay, the distances agree
to float tolerance).
"""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds, build, engine, filter_training, tree
from repro.obs import audit as j_audit
from repro.obs import trace as j_trace
from repro_torch import bridge
from repro_torch.core import bounds as t_bounds
from repro_torch.core import engine as t_engine
from repro_torch.core import tree as t_tree
from repro_torch.data.series import make_query_set
from repro_torch.obs import audit as t_audit
from repro_torch.obs import trace as t_trace
from _hypothesis_compat import given, settings, st
from test_torch_isax import carry, isax_config
from _torch_threads import one_torch_thread  # noqa: F401

#: (strategy, dist_impl) of the engine
PLANS = [("scan", None), ("compact", "direct"), ("compact", "pairwise")]
#: the outputs an answer is made of, compared bitwise inside the port
ANSWER = ("topk_d", "topk_i", "n_searched", "n_pruned_lb", "n_pruned_filter",
          "n_computed")


def _synthetic_predictions(d_lb, seed=0):
    """``tests/test_obs.py``'s noisy per-leaf predictions."""
    lb = np.asarray(d_lb)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal(lb.shape).astype(np.float32)
    return (lb * (1.4 + 0.4 * noise) + 2.0).astype(np.float32)


def _carry_tree(idx):
    return bridge.leafi_from_arrays(
        index={"kind": idx.kind, "series": np.asarray(idx.series),
               "order": np.asarray(idx.order),
               "leaf_start": np.asarray(idx.leaf_start),
               "leaf_size": np.asarray(idx.leaf_size),
               "max_leaf_size": idx.max_leaf_size,
               "n_series": idx.n_series, "length": idx.length,
               "payload": {k: np.asarray(v) for k, v in idx.payload.items()}},
        filter_params=None, leaf_ids=[], tuner=None, device="cpu").index


@pytest.fixture(scope="module", params=["dstree", "isax"])
def trees(request, randwalk_small, queries_small):
    build_tree = (tree.build_dstree if request.param == "dstree"
               else tree.build_isax)
    ref = build_tree(randwalk_small, 64)
    d_lb = np.array(bounds.lower_bounds(ref, jnp.asarray(queries_small)))
    return ref, _carry_tree(ref), d_lb, _synthetic_predictions(d_lb)


def _ref_cascade(index, q, d_lb, d_F, k, strategy, dist_impl=None, **kw):
    if kw.get("bsf_ub") is not None:
        kw["bsf_ub"] = jnp.asarray(kw["bsf_ub"])
    return engine.run_cascade(
        jnp.asarray(index.series), jnp.asarray(index.leaf_start),
        jnp.asarray(index.leaf_size), jnp.asarray(q), jnp.asarray(d_lb),
        jnp.asarray(d_F), k=k, max_leaf=index.max_leaf_size,
        strategy=strategy, dist_impl=dist_impl, **kw)


def _port_cascade(index, q, d_lb, d_F, k, strategy, dist_impl=None, **kw):
    return t_engine.run_cascade(
        index.series, index.leaf_start, index.leaf_size, torch.from_numpy(q),
        torch.from_numpy(d_lb), torch.from_numpy(d_F), k=k,
        max_leaf=index.max_leaf_size, strategy=strategy, dist_impl=dist_impl,
        **kw)


def _exact_bound(dists, k):
    """A valid prune-only bound: the exact k-th distance, inflated (the
    reference tests' construction)."""
    return (np.asarray(dists)[:, k - 1] * (1 + 1e-6) + 1e-6).astype(
        np.float32)


def _assert_trace_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype == np.int64, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _assert_audit_close(got: dict, want: dict):
    """Integer fields exactly; float fields within rtol 1e-5 of the
    field's largest finite value, infinities in the same places."""
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        if want[name].dtype == np.int64:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=name)
            continue
        finite = np.isfinite(want[name])
        scale = float(np.abs(want[name][finite]).max(initial=0.0))
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


def _assert_identities(trace: dict, audit: dict, n_leaves: int,
                       n_queries: int):
    """Both accounting identities, the leaf sums of the audit equal to the
    query sums of the trace, and the histogram's mass."""
    pruned = (trace["pruned_box"] + trace["pruned_seed"]
              + trace["pruned_filter"])
    assert (n_leaves - trace["survivors"] - trace["probed"] - pruned
            == 0).all()
    assert (n_queries - audit["kept"] - audit["pruned_box"]
            - audit["pruned_seed"] - audit["pruned_filter"] == 0).all()
    for name in ("pruned_box", "pruned_seed", "pruned_filter"):
        assert audit[name].sum() == trace[name].sum(), name
    np.testing.assert_array_equal(audit["resid_buckets"].sum(-1),
                                  audit["resid_count"])


@pytest.mark.parametrize("bound", [False, True],
                         ids=["unbounded", "bounded"])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("plan", PLANS, ids=lambda p: p[1] or p[0])
def test_engine_trace_and_audit_match_reference(trees, queries_small, plan,
                                                k, bound):
    ref_index, index, d_lb, d_F = trees
    strategy, impl = plan
    q = queries_small
    ub = None
    if bound:
        no_f = np.full(d_F.shape, -np.inf, np.float32)
        exact = _port_cascade(index, q, d_lb, no_f, k, strategy, impl)
        ub = _exact_bound(exact.topk_d, k)
    want = _ref_cascade(ref_index, q, d_lb, d_F, k, strategy, impl,
                        bsf_ub=ub, trace=True, audit=True)
    got = _port_cascade(index, q, d_lb, d_F, k, strategy, impl, bsf_ub=ub,
                        trace=True, audit=True)
    plain = _port_cascade(index, q, d_lb, d_F, k, strategy, impl, bsf_ub=ub)
    assert plain.trace is None and plain.audit is None
    for name in ANSWER:                     # trace and audit change nothing
        a, b = getattr(plain, name), getattr(got, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    np.testing.assert_array_equal(got.topk_i.numpy(), np.asarray(want.topk_i))
    for name in ANSWER[2:5]:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.topk_d.numpy(), np.asarray(want.topk_d),
                               rtol=1e-5, atol=1e-5)
    trace, audit = t_trace.to_numpy(got.trace), t_audit.to_numpy(got.audit)
    _assert_trace_equal(trace, j_trace.to_numpy(want.trace))
    _assert_audit_close(audit, j_audit.to_numpy(want.audit))
    _assert_identities(trace, audit, index.n_leaves, q.shape[0])
    assert trace["pruned_filter"].sum() > 0 and audit["kept"].sum() > 0
    assert (audit["scored"] >= audit["kept"]).all()
    assert (audit["violations"] <= audit["resid_count"]).all()
    if strategy == "scan":
        assert (trace["survivors"] == got.n_searched.numpy()).all()
        assert not trace["probed"].any()
    else:
        assert (trace["probed"] == 1).all()
    if not bound:
        assert trace["pruned_seed"].sum() == 0


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: p[1] or p[0])
def test_bound_prunes_only_and_its_seed_attribution(trees, queries_small,
                                                    plan):
    """``tests/test_obs.py``'s warm-bound pin on the port, with the bound
    built from exact results: answers bitwise those of the unbounded run
    (under ``pairwise`` the ids, and the distances to float tolerance),
    never more leaves searched; seed prunes zero on the scan (in
    ascending-lb order a valid bound never undercuts the converged bsf)
    and live on the compact strategy (the probe's bsf0 is undercut
    wherever the probe leaf is not the nearest one's); the trace equal to
    the reference's; the audit's seed prunes the trace's."""
    ref_index, index, d_lb, _ = trees
    strategy, impl = plan
    q = queries_small
    no_f = np.full(d_lb.shape, -np.inf, np.float32)
    cold = _port_cascade(index, q, d_lb, no_f, 1, strategy, impl, trace=True)
    assert int(cold.trace.pruned_seed.sum()) == 0
    assert not t_trace.accounting_residual(cold.trace, index.n_leaves).any()
    ub = _exact_bound(cold.topk_d, 1)
    warm = _port_cascade(index, q, d_lb, no_f, 1, strategy, impl, bsf_ub=ub,
                         trace=True, audit=True)
    assert torch.equal(warm.topk_i, cold.topk_i)
    if impl == "pairwise":
        # the union, and with it the shapes of its matrix products, shrinks
        # with the bound: the distances agree to float tolerance only
        torch.testing.assert_close(warm.topk_d, cold.topk_d, rtol=1e-5,
                                   atol=1e-5)
    else:
        assert torch.equal(warm.topk_d.view(torch.int32),
                           cold.topk_d.view(torch.int32))
    assert (warm.n_searched <= cold.n_searched).all()
    seed = int(warm.trace.pruned_seed.sum())
    if strategy == "scan":
        assert seed == 0
    else:
        assert seed > 0
    if impl == "direct":             # a union's queries share its count
        assert (warm.n_computed <= cold.n_computed).all()
        assert (warm.n_computed < cold.n_computed).any()
    assert int(warm.audit.pruned_seed.sum()) == seed
    assert not t_trace.accounting_residual(warm.trace, index.n_leaves).any()
    assert not t_audit.accounting_residual_leaf(warm.audit,
                                                q.shape[0]).any()
    want = _ref_cascade(ref_index, q, d_lb, no_f, 1, strategy, impl,
                        bsf_ub=ub, trace=True)
    _assert_trace_equal(t_trace.to_numpy(warm.trace),
                        j_trace.to_numpy(want.trace))


def _dstree_config(mod, training):
    return mod.LeaFiConfig(backbone="dstree", leaf_capacity=64, n_global=60,
                           n_local=16, t_filter_over_t_series=10.0,
                           train=training.TrainConfig(epochs=5))


@pytest.fixture(scope="module", params=["dstree", "isax"])
def built(request, randwalk_small):
    config = (_dstree_config if request.param == "dstree" else isax_config)
    ref = build.build_leafi(randwalk_small[:1500],
                            config(build, filter_training))
    assert len(ref.leaf_ids) > 4
    return ref, carry(ref)


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("plan", PLANS, ids=lambda p: p[1] or p[0])
def test_search_batched_trace_and_audit_match_reference(built, queries_small,
                                                        plan, k):
    """``search_batched`` (through ``LeaFiIndex.search``) with trace and
    audit, exact and at 0.99, with and without a valid bound, in both
    packages: answers, counters, trace and integer audit fields equal;
    trace and audit off give the same answers; exact search with the bound
    is bitwise the unbounded one (under ``pairwise`` its ids, and its
    distances to float tolerance) and searches no more leaves."""
    ref, port = built
    strategy, impl = plan
    q = queries_small
    kw = dict(k=k, strategy=strategy, dist_impl=impl)
    exact = port.search(q, quality_target=None, device="cpu", **kw)
    ub = _exact_bound(exact.dists, k)
    for target in (None, 0.99):
        for bsf_ub in (None, ub):
            want = ref.search(q, quality_target=target, bsf_ub=bsf_ub,
                              trace=True, audit=True, **kw)
            got = port.search(q, quality_target=target, bsf_ub=bsf_ub,
                              trace=True, audit=True, device="cpu", **kw)
            plain = port.search(q, quality_target=target, bsf_ub=bsf_ub,
                                device="cpu", **kw)
            assert plain.trace is None and plain.audit is None
            for name in ("dists", "ids", "searched", "pruned_lb",
                         "pruned_filter", "computed"):
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(plain, name))
            for name in ("ids", "searched", "pruned_lb", "pruned_filter"):
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(want, name))
            np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5,
                                       atol=1e-5)
            _assert_trace_equal(got.trace, want.trace)
            _assert_audit_close(got.audit, want.audit)
            _assert_identities(got.trace, got.audit, port.index.n_leaves,
                               q.shape[0])
            if target is None:
                np.testing.assert_array_equal(got.ids, exact.ids)
                if impl == "pairwise":
                    np.testing.assert_allclose(got.dists, exact.dists,
                                               rtol=1e-5, atol=1e-5)
                else:
                    np.testing.assert_array_equal(
                        got.dists.view(np.int32), exact.dists.view(np.int32))
                assert (got.searched <= exact.searched).all()
                assert got.pruned_filter.sum() == 0
            else:
                assert got.trace["pruned_filter"].sum() > 0
            if bsf_ub is None:
                assert got.trace["pruned_seed"].sum() == 0


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2 ** 31 - 1),
       backbone=st.sampled_from(["dstree", "isax"]),
       strategy=st.sampled_from(["scan", "compact"]))
def test_accounting_residual_zero_property(seed, backbone, strategy):
    """``tests/test_obs.py``'s property on the port's own trees: the trace's
    accounting residual is zero per query and the audit's per leaf, across
    random leaf layouts, random filter planes and random valid bounds."""
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((512, 32), dtype=np.float32).cumsum(axis=1)
    cap = int(8 + (seed % 5) * 12)
    build_tree = t_tree.build_dstree if backbone == "dstree" \
        else t_tree.build_isax
    index = build_tree(S, cap)
    queries = make_query_set(S, 4, noise=0.3, seed=seed % 997)
    d_lb = t_bounds.lower_bounds(index, torch.from_numpy(queries)).numpy()
    no_f = np.full(d_lb.shape, -np.inf, np.float32)
    keep = rng.random(d_lb.shape) < 0.5
    d_F = np.where(keep, no_f, _synthetic_predictions(d_lb, seed=seed))
    exact = _port_cascade(index, queries, d_lb, no_f, 1, strategy)
    ub = _exact_bound(exact.topk_d, 1)
    res = _port_cascade(index, queries, d_lb, d_F.astype(np.float32), 1,
                        strategy, trace=True, audit=True, bsf_ub=ub)
    assert not t_trace.accounting_residual(res.trace, index.n_leaves).any()
    assert not t_audit.accounting_residual_leaf(res.audit, 4).any()


def test_chip_smoke_trace_phase_on_the_cpu(built, queries_small):
    """``chip_smoke.run_trace_audit`` and the scan check of the d = 128
    DSTree (``_scan_trace_audit``), rehearsed on the carried index on the
    CPU: every batch's identities hold, the bound's exact answers are
    bitwise the unbounded ones with seed prunes, and the phase reports
    its runs and walls."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, port = built
    out = smoke.run_trace_audit(port, queries_small, device="cpu",
                                impls=(None, "pairwise"), label="cpu ",
                                reps=1)
    assert len(out["runs"]) == 12 and set(out["wall_ms"]) == {
        "untraced", "traced and audited"}
    assert all(v["pruned_seed"] > 0 for key, v in out["runs"].items()
               if key.endswith("exact bound"))
    smoke._scan_trace_audit(port, queries_small[:8], "cpu", "cpu ")
