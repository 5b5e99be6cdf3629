"""The port's single-query early-termination search and its grouped
per-target search against the JAX package's, on the CPU.

Reference-built DSTree and iSAX LeaFi indexes are carried across by
``repro_torch.bridge``.  ``search_early`` must give the reference's ids and
its three counters (searched, pruned by lower bound, pruned by filter)
exactly and distances within rtol 1e-5, exact and at quality targets, k = 1
and 5; exact ``search_early`` equals the port's own batched search (the
reference's ``test_early_search_equals_batched``).  The grouped search
gives the reference's ids and counters exactly on a mixed-target batch
(both under ``strategy="scan"``, which the reference compiles once per
sub-batch shape; the port's scan and compact strategies agree bitwise, see
``test_torch_engine.py``), and
agrees with the port's vectorised per-query search within the slack the
reference's serving tests allow (prune decisions tied within an ulp)."""
import numpy as np
import pytest
import torch

from repro.core import build, filter_training, search
from repro_torch.core import search as t_search
from test_torch_isax import carry, isax_config
from _torch_threads import one_torch_thread  # noqa: F401

N_EARLY = 8


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


def _kw(lfi):
    return dict(filter_params=lfi.filter_params, leaf_ids=lfi.leaf_ids,
                tuner=lfi.tuner)


def _mixed_targets(n):
    """Three targets, interleaved in a seeded order, in groups of equal size
    (one sub-batch shape, so the reference compiles its programs once)."""
    return np.random.default_rng(11).permutation(
        np.repeat([0.7, 0.85, 0.95], n // 3))


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("target", [None, 0.9, 0.99], ids=str)
def test_search_early_matches_reference(built, queries_small, k, target):
    ref, port = built
    exact = target is None                       # filters off
    pruned_filter = 0
    for qi in range(N_EARLY):
        want = search.search_early(ref.index, queries_small[qi], k=k,
                                   quality_target=target,
                                   use_filters=not exact, **_kw(ref))
        got = t_search.search_early(port.index, queries_small[qi], k=k,
                                    quality_target=target,
                                    use_filters=not exact, device="cpu",
                                    **_kw(port))
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.searched, want.searched)
        np.testing.assert_array_equal(got.pruned_lb, want.pruned_lb)
        np.testing.assert_array_equal(got.pruned_filter, want.pruned_filter)
        np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5,
                                   atol=1e-5)
        assert got.n_leaves == want.n_leaves
        assert (got.searched + got.pruned_lb + got.pruned_filter
                <= got.n_leaves).all()
        pruned_filter += int(got.pruned_filter.sum())
    if exact:
        assert pruned_filter == 0
    elif target == 0.9:
        assert pruned_filter > 0                 # the skip branch runs


def test_early_search_equals_batched(built, queries_small):
    _, port = built
    for qi in range(4):
        r1 = t_search.search_early(port.index, queries_small[qi],
                                   use_filters=False, device="cpu")
        r2 = t_search.search_batched(port.index, queries_small[qi:qi + 1],
                                     use_filters=False, device="cpu")
        np.testing.assert_allclose(r1.dists, r2.dists, rtol=1e-5)
        assert r1.ids[0, 0] == r2.ids[0, 0]


def test_grouped_matches_reference(built, queries_small):
    ref, port = built
    q = queries_small[:24]
    targets = _mixed_targets(len(q))
    want = search.search_batched_grouped(ref.index, q, targets, k=5,
                                         strategy="scan", **_kw(ref))
    got = t_search.search_batched_grouped(port.index, q, targets, k=5,
                                          strategy="scan", device="cpu",
                                          **_kw(port))
    np.testing.assert_array_equal(got.ids, want.ids)
    for name in ("searched", "pruned_lb", "pruned_filter", "computed"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("strategy", ["scan", "compact"])
def test_grouped_matches_vectorised(built, queries_small, strategy):
    _, port = built
    q = queries_small[:24]
    targets = _mixed_targets(len(q))
    vec = t_search.search_batched(port.index, q, k=5, quality_target=targets,
                                  strategy=strategy, device="cpu",
                                  **_kw(port))
    grp = t_search.search_batched_grouped(port.index, q, targets, k=5,
                                          strategy=strategy, device="cpu",
                                          **_kw(port))
    np.testing.assert_allclose(vec.dists, grp.dists, rtol=1e-5, atol=1e-6)
    assert np.abs(vec.searched - grp.searched).max() <= 2
    assert (vec.ids != grp.ids).mean() <= 0.02


def test_grouped_rejects_a_target_count_mismatch(built, queries_small):
    _, port = built
    with pytest.raises(ValueError, match="targets for"):
        t_search.search_batched_grouped(port.index, queries_small,
                                        np.full(3, 0.9), device="cpu",
                                        **_kw(port))


def test_new_searches_default_to_the_card(built, queries_small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, port = built
    with pytest.raises(RuntimeError, match="CUDA"):
        t_search.search_early(port.index, queries_small[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_search.search_batched_grouped(port.index, queries_small[:4],
                                        np.full(4, 0.9), **_kw(port))
