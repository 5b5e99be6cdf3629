"""The port's iSAX backbone against the JAX package's, on the CPU.

SAX breakpoints within 2 ulp (the reference evaluates ndtri in float32, the
port in float64 and rounds); at this size the trees are identical: order,
leaf offsets, words and cardinalities exactly, symbol edges to 2.4e-7
(the breakpoints' 2 ulp).  A reference-built iSAX LeaFi index carried
across by ``repro_torch.bridge`` answers with the reference's ids and
searched/pruned counters exactly and distances within 1e-5, at exact,
0.9, 0.95, 0.99 and per-query targets, k = 1 and 5; the port's own
``build_leafi(backbone="isax")`` selects the reference's leaves."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds, build, filter_training, summaries, tree
from repro_torch import bridge
from repro_torch.core import bounds as t_bounds
from repro_torch.core import build as t_build
from repro_torch.core import filter_training as t_training
from repro_torch.core import summaries as t_summaries
from repro_torch.core import tree as t_tree
from _torch_threads import one_torch_thread  # noqa: F401

TARGETS = [None, 0.9, 0.95, 0.99, "per-query"]


def carry(lfi, with_calib: bool = False):
    """A reference LeaFiIndex across the bridge, onto the CPU."""
    idx = lfi.index
    calib = None
    if with_calib:
        calib = {"queries": lfi.calib.queries, "d_lb": lfi.calib.d_lb,
                 "d_L": lfi.calib.d_L}
    return bridge.leafi_from_arrays(
        index={"kind": idx.kind, "series": np.asarray(idx.series),
               "order": np.asarray(idx.order),
               "leaf_start": np.asarray(idx.leaf_start),
               "leaf_size": np.asarray(idx.leaf_size),
               "max_leaf_size": idx.max_leaf_size,
               "n_series": idx.n_series, "length": idx.length,
               "payload": {k: np.asarray(v) for k, v in idx.payload.items()}},
        filter_params={k: np.asarray(v)
                       for k, v in lfi.filter_params.items()},
        leaf_ids=np.asarray(lfi.leaf_ids),
        tuner={"knots_q": lfi.tuner.knots_q, "knots_o": lfi.tuner.knots_o,
               "slopes": lfi.tuner.slopes,
               "max_offset": lfi.tuner.max_offset},
        calib=calib, device="cpu")


def target(name, n):
    if name == "per-query":
        return np.random.default_rng(0).choice([0.9, 0.95, 0.99], n)
    return name


def assert_same_answers(port, ref, queries, k, qt):
    want = ref.search(queries, k=k, quality_target=qt)
    got = port.search(queries, k=k, quality_target=qt, device="cpu")
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.searched, want.searched)
    np.testing.assert_array_equal(got.pruned_lb, want.pruned_lb)
    np.testing.assert_array_equal(got.pruned_filter, want.pruned_filter)
    np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5, atol=1e-5)
    return got


def isax_config(mod, training):
    return mod.LeaFiConfig(backbone="isax", leaf_capacity=64, n_global=60,
                           n_local=16, t_filter_over_t_series=10.0,
                           train=training.TrainConfig(epochs=5))


@pytest.mark.parametrize("bits", range(1, 9))
def test_sax_breakpoints_within_two_ulp(bits):
    want = np.asarray(summaries.sax_breakpoints(bits))
    got = t_summaries.sax_breakpoints(bits).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == ((1 << bits) - 1,)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2


def test_sax_from_paa_and_edges_match_reference(randwalk_small):
    paa = np.asarray(summaries.paa(summaries.znormalize(
        randwalk_small[:500]), 8))
    for bits in (1, 4, 8):
        np.testing.assert_array_equal(
            t_summaries.sax_from_paa(torch.from_numpy(paa), bits).numpy(),
            np.asarray(summaries.sax_from_paa(jnp.asarray(paa), bits)))
    rng = np.random.default_rng(0)
    card = rng.integers(0, 9, (40, 8))
    sym = rng.integers(0, 1 << 8, (40, 8)) >> (8 - card)
    want = summaries.sax_symbol_edges(sym, card)
    got = t_summaries.sax_symbol_edges(sym, card)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


@pytest.fixture(scope="module", params=[(4000, 64), (1500, 32)],
                ids=["4000-64", "1500-32"])
def both_trees(request, randwalk_small):
    n, cap = request.param
    S = randwalk_small[:n]
    return tree.build_isax(S, leaf_capacity=cap), \
        t_tree.build_isax(S, leaf_capacity=cap)


def test_build_isax_matches_reference(both_trees):
    ref, got = both_trees
    assert got.kind == ref.kind == "isax"
    for name in ("order", "leaf_start", "leaf_size"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert got.max_leaf_size == ref.max_leaf_size
    assert (got.n_series, got.length) == (ref.n_series, ref.length)
    for name in ("sax_word", "sax_bits"):
        np.testing.assert_array_equal(got.payload[name].numpy(),
                                      np.asarray(ref.payload[name]))
    want = np.asarray(ref.payload["sax_edges"])
    edges = got.payload["sax_edges"].numpy()
    np.testing.assert_array_equal(np.isinf(edges), np.isinf(want))
    np.testing.assert_allclose(edges, want, rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(got.series.numpy(), np.asarray(ref.series),
                               rtol=1e-6, atol=1e-6)


def test_isax_lower_bounds_match_reference(both_trees, queries_small):
    ref, got = both_trees
    want = np.asarray(bounds.lower_bounds(ref, jnp.asarray(queries_small)))
    lb = t_bounds.lower_bounds(got, torch.from_numpy(queries_small))
    np.testing.assert_allclose(lb.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def built(randwalk_small):
    ref = build.build_leafi(randwalk_small[:1500],
                            isax_config(build, filter_training))
    return ref, carry(ref)


def test_bridge_carries_the_config(built):
    ref, port = built
    assert port.config.backbone == "isax"
    assert port.config.word_len == ref.config.word_len
    assert port.config.weight_dtype == "float32"
    assert port.index.order.dtype == torch.int64
    assert port.index.payload["sax_word"].dtype == torch.int32
    assert port.calib is None


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("qt", TARGETS, ids=str)
def test_carried_isax_index_matches_reference(built, queries_small, k, qt):
    ref, port = built
    assert len(ref.leaf_ids) > 4
    got = assert_same_answers(port, ref, queries_small, k,
                              target(qt, len(queries_small)))
    if qt == 0.95:
        assert got.pruned_filter.sum() > 0       # the filters do prune


def test_port_build_isax_end_to_end(built, randwalk_small, queries_small):
    ref, _ = built
    lfi = t_build.build_leafi(randwalk_small[:1500],
                              isax_config(t_build, t_training), device="cpu")
    assert lfi.index.kind == "isax"
    assert lfi.build_report["n_leaves"] == ref.build_report["n_leaves"]
    np.testing.assert_array_equal(lfi.leaf_ids, ref.leaf_ids)
    exact = lfi.search_exact(queries_small, k=5, device="cpu")
    want = ref.search_exact(queries_small, k=5)
    np.testing.assert_array_equal(exact.ids, want.ids)
    np.testing.assert_allclose(exact.dists, want.dists, rtol=1e-5, atol=1e-5)
    for qt in (0.99, target("per-query", len(queries_small))):
        r = lfi.search(queries_small, k=1, quality_target=qt, device="cpu")
        assert np.isfinite(r.dists).all()
        assert (r.searched + r.pruned_lb + r.pruned_filter
                == lfi.index.n_leaves).all()
