"""The port's DSTree builder, summaries and lower bounds against the JAX
package's, on the same numpy series (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds, selection, summaries, tree
from repro.data import series as series_mod
from repro_torch.core import bounds as t_bounds
from repro_torch.core import selection as t_selection
from repro_torch.core import summaries as t_summaries
from repro_torch.core import tree as t_tree
from repro_torch.data import series as t_series
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=[(2000, 64), (1500, 32)])
def both_trees(request, randwalk_small):
    n, cap = request.param
    S = randwalk_small[:n]
    return S, tree.build_dstree(S, leaf_capacity=cap), \
        t_tree.build_dstree(S, leaf_capacity=cap)


def test_build_dstree_matches_reference(both_trees):
    _, ref, got = both_trees
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(ref.order))
    np.testing.assert_array_equal(got.leaf_start.numpy(),
                                  np.asarray(ref.leaf_start))
    np.testing.assert_array_equal(got.leaf_size.numpy(),
                                  np.asarray(ref.leaf_size))
    assert got.max_leaf_size == ref.max_leaf_size
    assert (got.n_series, got.length) == (ref.n_series, ref.length)
    np.testing.assert_allclose(got.series.numpy(), np.asarray(ref.series),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.payload["eapca_box"].numpy(),
                               np.asarray(ref.payload["eapca_box"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.payload["seg_len"].numpy(),
                                  np.asarray(ref.payload["seg_len"]))


def test_lower_bounds_match_reference(both_trees, queries_small):
    _, ref, got = both_trees
    want = np.asarray(bounds.lower_bounds(ref, jnp.asarray(queries_small)))
    lb = t_bounds.lower_bounds(got, torch.from_numpy(queries_small))
    np.testing.assert_allclose(lb.numpy(), want, rtol=1e-6, atol=1e-6)


def test_summaries_match_reference(randwalk_small):
    x = randwalk_small[:50, :90]                     # m not a multiple of s
    for s in (8, 7):
        np.testing.assert_allclose(
            t_summaries.paa(torch.from_numpy(x), s).numpy(),
            np.asarray(summaries.paa(jnp.asarray(x), s)), rtol=1e-6,
            atol=1e-5)
        np.testing.assert_allclose(
            t_summaries.segment_stats(torch.from_numpy(x), s).numpy(),
            np.asarray(summaries.segment_stats(jnp.asarray(x), s)),
            rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(
        t_summaries.znormalize(torch.from_numpy(x)).numpy(),
        summaries.znormalize(x), rtol=1e-6, atol=1e-6)
    st = np.asarray(summaries.segment_stats(jnp.asarray(x), 8))
    np.testing.assert_array_equal(t_summaries.eapca_node_box(st),
                                  summaries.eapca_node_box(st))


def test_sax_lower_bound_matches_reference():
    rng = np.random.default_rng(0)
    edges = np.sort(rng.standard_normal((9, 8, 2)), axis=-1).astype(
        np.float32)
    edges[0, :, 0], edges[1, :, 1] = -np.inf, np.inf
    qpaa = rng.standard_normal((5, 8)).astype(np.float32)
    np.testing.assert_allclose(
        t_bounds.sax_lower_bound(torch.from_numpy(qpaa),
                                 torch.from_numpy(edges), 96).numpy(),
        np.asarray(bounds.sax_lower_bound(jnp.asarray(qpaa),
                                          jnp.asarray(edges), 96)),
        rtol=1e-6, atol=1e-6)


def test_select_leaves_matches_reference():
    sizes = np.random.default_rng(1).integers(1, 300, 500)
    for t, budget in ((10.0, 6 << 30), (60.0, 100_000), (279.0, 6 << 30)):
        kw = dict(t_filter=t, t_series=1.0, a=2.0, filter_bytes=37_000,
                  memory_budget_bytes=budget)
        np.testing.assert_array_equal(
            t_selection.select_leaves(sizes, **kw),
            selection.select_leaves(sizes, **kw))


def test_data_generators_match_reference():
    np.testing.assert_array_equal(t_series.randwalk(30, 16, seed=4),
                                  series_mod.randwalk(30, 16, seed=4))
    np.testing.assert_array_equal(
        t_series.make_series_dataset("randwalk", 20, seed=1),
        series_mod.make_series_dataset("randwalk", 20, seed=1))
    S = series_mod.randwalk(200, 48, seed=2)
    np.testing.assert_allclose(t_series.make_query_set(S, 9, 0.2, seed=3),
                               series_mod.make_query_set(S, 9, 0.2, seed=3),
                               rtol=1e-5, atol=1e-5)
