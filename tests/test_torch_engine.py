"""The port's search engine against the JAX package's on the same pruning
inputs (d_lb, d_F as numpy), on the CPU.

Across frameworks: top-k ids and the searched/pruned counters exactly,
distances within 1e-5 (f32 sums in another order).  Inside the port: scan
and compact agree bitwise under the ``direct`` distance impl, as they do in
the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds, engine, tree
from repro_torch.core import engine as t_engine
from repro_torch.core import tree as t_tree
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def indexes(randwalk_small):
    S = randwalk_small[:2000]
    return tree.build_dstree(S, leaf_capacity=64), \
        t_tree.build_dstree(S, leaf_capacity=64)


def _inputs(ref_index, queries, filtered):
    d_lb = np.array(bounds.lower_bounds(ref_index, jnp.asarray(queries)))
    if not filtered:
        return d_lb, np.full(d_lb.shape, -np.inf, np.float32)
    noise = np.random.default_rng(0).standard_normal(d_lb.shape)
    return d_lb, (d_lb * (1.4 + 0.4 * noise) + 2.0).astype(np.float32)


def _ref_run(index, q, d_lb, d_F, k, strategy):
    r = engine.run_cascade(
        jnp.asarray(index.series), jnp.asarray(index.leaf_start),
        jnp.asarray(index.leaf_size), jnp.asarray(q), jnp.asarray(d_lb),
        jnp.asarray(d_F), k=k, max_leaf=index.max_leaf_size,
        strategy=strategy)
    return [np.asarray(a) for a in (r.topk_d, r.topk_i, r.n_searched,
                                    r.n_pruned_lb, r.n_pruned_filter)]


def _port_run(index, q, d_lb, d_F, k, strategy, dist_impl=None):
    r = t_engine.run_cascade(
        index.series, index.leaf_start, index.leaf_size,
        torch.from_numpy(q), torch.from_numpy(d_lb), torch.from_numpy(d_F),
        k=k, max_leaf=index.max_leaf_size, strategy=strategy,
        dist_impl=dist_impl)
    return [a.numpy() for a in (r.topk_d, r.topk_i, r.n_searched,
                                r.n_pruned_lb, r.n_pruned_filter,
                                r.n_computed)]


def _assert_matches(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:5], want[1:5]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("k", [1, 10])
def test_engine_matches_reference(indexes, queries_small, k, filtered):
    ref_index, index = indexes
    q = queries_small[:16]
    d_lb, d_F = _inputs(ref_index, q, filtered)
    want = _ref_run(ref_index, q, d_lb, d_F, k, "compact")
    scan = _port_run(index, q, d_lb, d_F, k, "scan")
    compact = _port_run(index, q, d_lb, d_F, k, "compact")
    if filtered:
        assert want[4].sum() > 0                  # the filter cascade is on
    _assert_matches(compact, want)
    for a, b in zip(scan[:5], compact[:5]):      # bitwise under "direct"
        np.testing.assert_array_equal(a, b)
    assert (compact[5] >= compact[2]).all()
    assert (compact[5] <= index.n_leaves).all()


def test_all_leaves_survive(indexes, queries_small):
    """Zero lower bounds, no filters: nothing prunes; compact degrades to the
    full-width bucket and stays exact."""
    ref_index, index = indexes
    q = queries_small[:16]
    d_lb = np.zeros((16, index.n_leaves), np.float32)
    d_F = np.full(d_lb.shape, -np.inf, np.float32)
    scan = _port_run(index, q, d_lb, d_F, 3, "scan")
    compact = _port_run(index, q, d_lb, d_F, 3, "compact")
    for a, b in zip(scan[:5], compact[:5]):
        np.testing.assert_array_equal(a, b)
    _assert_matches(compact, _ref_run(ref_index, q, d_lb, d_F, 3, "compact"))
    assert (compact[5] == index.n_leaves).all()


def test_k_larger_than_leaf_capacity(indexes, queries_small):
    ref_index, index = indexes
    q = queries_small[:16]
    d_lb, d_F = _inputs(ref_index, q, True)
    k = index.max_leaf_size + 17
    scan = _port_run(index, q, d_lb, d_F, k, "scan")
    compact = _port_run(index, q, d_lb, d_F, k, "compact")
    for a, b in zip(scan[:5], compact[:5]):
        np.testing.assert_array_equal(a, b)
    _assert_matches(compact, _ref_run(ref_index, q, d_lb, d_F, k, "compact"))


@pytest.mark.parametrize("dist_impl", ["matmul", "pairwise"])
def test_lossy_impls_close_to_direct(indexes, queries_small, dist_impl):
    """The matmul-decomposed candidate passes (per-query gathered; the
    union slab through the pairwise kernel's plain version here) make the
    same decisions as ``direct`` on well-separated data."""
    ref_index, index = indexes
    q = queries_small
    d_lb, d_F = _inputs(ref_index, q, True)
    a = _port_run(index, q, d_lb, d_F, 5, "compact", "direct")
    b = _port_run(index, q, d_lb, d_F, 5, "compact", dist_impl)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-4, atol=1e-4)
    for x, y in zip(a[1:5], b[1:5]):
        np.testing.assert_array_equal(x, y)
    assert (b[5] >= b[2]).all()


def test_replay_cascade_matches_reference(indexes, queries_small):
    ref_index, _ = indexes
    q = queries_small
    d_lb, d_F = _inputs(ref_index, q, True)
    rng = np.random.default_rng(4)
    leaf_d = np.sort(rng.random((q.shape[0], d_lb.shape[1], 3)) * 30,
                     axis=-1).astype(np.float32)
    leaf_i = rng.integers(0, 2000, leaf_d.shape)
    order = np.argsort(d_lb, axis=1, kind="stable")
    want = engine.replay_cascade(jnp.asarray(leaf_d), jnp.asarray(leaf_i),
                                 jnp.asarray(d_lb), jnp.asarray(d_F),
                                 jnp.asarray(order), k=2)
    got = t_engine.replay_cascade(
        torch.from_numpy(leaf_d), torch.from_numpy(leaf_i),
        torch.from_numpy(d_lb), torch.from_numpy(d_F),
        torch.from_numpy(order), k=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
