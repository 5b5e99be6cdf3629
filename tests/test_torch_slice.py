"""The slice as a whole: a LeaFi index built by the JAX reference, carried
across by ``repro_torch.bridge``, answers the same batched kNN queries as
the reference — ids and searched/pruned counters exactly, distances within
1e-5 — at exact, 0.9, 0.95, 0.99 and per-query targets, k = 1 and 5.  The
port's own ``build_leafi`` runs end to end at the same size (CPU)."""
import numpy as np
import pytest

from repro.core import build, filter_training
from repro_torch import bridge
from repro_torch.core import build as t_build
from repro_torch.core import filter_training as t_training
from _torch_threads import one_torch_thread  # noqa: F401

TARGETS = [None, 0.9, 0.95, 0.99, "per-query"]


def _config(mod, training):
    return mod.LeaFiConfig(backbone="dstree", leaf_capacity=64, n_global=60,
                           n_local=16, t_filter_over_t_series=10.0,
                           train=training.TrainConfig(epochs=5))


@pytest.fixture(scope="module")
def built(randwalk_small):
    ref = build.build_leafi(randwalk_small[:1500],
                            _config(build, filter_training))
    idx = ref.index
    port = bridge.leafi_from_arrays(
        index={"kind": idx.kind, "series": np.asarray(idx.series),
               "order": np.asarray(idx.order),
               "leaf_start": np.asarray(idx.leaf_start),
               "leaf_size": np.asarray(idx.leaf_size),
               "max_leaf_size": idx.max_leaf_size,
               "n_series": idx.n_series, "length": idx.length,
               "payload": {k: np.asarray(v) for k, v in idx.payload.items()}},
        filter_params={k: np.asarray(v)
                       for k, v in ref.filter_params.items()},
        leaf_ids=np.asarray(ref.leaf_ids),
        tuner={"knots_q": ref.tuner.knots_q, "knots_o": ref.tuner.knots_o,
               "slopes": ref.tuner.slopes,
               "max_offset": ref.tuner.max_offset},
        device="cpu")
    return ref, port


def _target(name, n):
    if name == "per-query":
        return np.random.default_rng(0).choice([0.9, 0.95, 0.99], n)
    return name


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("target", TARGETS, ids=str)
def test_carried_index_matches_reference(built, queries_small, k, target):
    ref, port = built
    assert len(ref.leaf_ids) > 4
    qt = _target(target, len(queries_small))
    want = ref.search(queries_small, k=k, quality_target=qt)
    got = port.search(queries_small, k=k, quality_target=qt, device="cpu")
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.searched, want.searched)
    np.testing.assert_array_equal(got.pruned_lb, want.pruned_lb)
    np.testing.assert_array_equal(got.pruned_filter, want.pruned_filter)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5, atol=1e-5)
    if target == 0.95:
        assert got.pruned_filter.sum() > 0       # the filters do prune


def test_port_build_leafi_end_to_end(built, randwalk_small, queries_small):
    ref, _ = built
    lfi = t_build.build_leafi(randwalk_small[:1500],
                              _config(t_build, t_training), device="cpu")
    rep = lfi.build_report
    for key in ("t_index_build", "t_collect", "t_train", "t_calibrate"):
        assert rep[key] >= 0
    # same tree and selection as the reference
    assert rep["n_leaves"] == ref.build_report["n_leaves"]
    np.testing.assert_array_equal(lfi.leaf_ids, ref.leaf_ids)
    assert lfi.tuner.knots_o.shape[0] == len(lfi.leaf_ids)
    exact = lfi.search_exact(queries_small, k=5, device="cpu")
    want = ref.search_exact(queries_small, k=5)
    np.testing.assert_array_equal(exact.ids, want.ids)
    np.testing.assert_allclose(exact.dists, want.dists, rtol=1e-5, atol=1e-5)
    for qt in (0.99, _target("per-query", len(queries_small))):
        r = lfi.search(queries_small, k=1, quality_target=qt, device="cpu")
        assert np.isfinite(r.dists).all()
        assert (r.searched + r.pruned_lb + r.pruned_filter
                == lfi.index.n_leaves).all()
