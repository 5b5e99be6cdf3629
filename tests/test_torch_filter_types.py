"""The port's CNN and LSTM filter backbones, and the options of its
``build_dstree`` and ``build_isax``, against the JAX package's, on the CPU.

The reference's parameter draws (``filters.init_cnn``/``init_rnn`` from a
JAX key) are carried across as numpy arrays, with biases and target
statistics drawn by numpy, and the queries come from a numpy seed: the
port's ``apply_cnn``/``apply_rnn`` (the plain versions the CPU runs) give
the reference's predictions within rtol = atol = 1e-5, at (F, Q, m) = (3,
5, 32) and (2, 4, 16), channels != m, ksize 2 and 5, hidden 32.  On a
reference-built DSTree and iSAX index whose MLP filters are swapped for
CNN or LSTM stacks (y_mean and y_std kept, so the predictions sit on the
distance scale) and whose tuner the reference refits on its own
predictions, carried across by ``repro_torch.bridge``: the filter lower
bounds of ``predictions_for_all_leaves`` (shared and per-query offsets,
-inf on unfiltered leaves) match to float tolerance, and
``LeaFiIndex.search`` (compact and scan), ``search_batched_grouped`` and
``search_early`` give the reference's ids and prune counters exactly,
distances within 1e-5, exact and at 0.99, k = 1 and 5.  The port's
trees take ``znorm`` and ``max_card_bits`` and equal the reference's with
them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build, conformal, filter_training, filters, search
from repro.core import summaries, tree
from repro_torch import bridge
from repro_torch.core import build as t_build
from repro_torch.core import filters as t_filters
from repro_torch.core import search as t_search
from repro_torch.core import summaries as t_summaries
from repro_torch.core import tree as t_tree
from test_torch_isax import carry, isax_config
from test_torch_isolation import _load_smoke
from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)

#: (filter type, F, Q, m, init keywords) of the prediction cases
APPLY_CASES = [
    ("cnn", 3, 5, 32, {}), ("cnn", 2, 4, 16, {}),
    ("cnn", 3, 5, 32, {"channels": 12}), ("cnn", 2, 4, 16, {"ksize": 2}),
    ("cnn", 3, 5, 32, {"channels": 7, "ksize": 5}),
    ("rnn", 3, 5, 32, {}), ("rnn", 2, 4, 16, {}),
    ("rnn", 3, 5, 32, {"hidden": 32}),
]


def _ref_params(ftype, F, m, seed=0, **kw):
    """The reference's initial stack as numpy arrays, with biases and
    target statistics drawn by numpy (so de-standardization is exercised)."""
    p = {k: np.asarray(v) for k, v in filters.INIT[ftype](
        jax.random.PRNGKey(seed), F, m, **kw).items()}
    rng = np.random.default_rng(seed + 100)
    p["b"] = rng.standard_normal(F).astype(np.float32)
    p["y_mean"] = rng.uniform(5.0, 15.0, F).astype(np.float32)
    p["y_std"] = rng.uniform(0.5, 2.0, F).astype(np.float32)
    return p


def _jnp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _torch(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("ftype,F,Q,m,kw", APPLY_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}-"
                              + "-".join(f"{k}{v}" for k, v in c[4].items())
                              for c in APPLY_CASES])
def test_apply_matches_reference(ftype, F, Q, m, kw):
    p = _ref_params(ftype, F, m, **kw)
    q = np.random.default_rng(1).standard_normal((Q, m)).astype(np.float32)
    want = np.asarray(filters.APPLY[ftype](_jnp(p), jnp.asarray(q)))
    got = t_filters.APPLY[ftype](_torch(p), torch.from_numpy(q))
    assert got.shape == (F, Q) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("ftype", ["cnn", "rnn"])
def test_destandardization(ftype):
    """The output is z · y_std + y_mean of the identity-statistics output."""
    p = _ref_params(ftype, 3, 16)
    q = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 16)).astype(np.float32))
    raw = dict(_torch(p), y_mean=torch.zeros(3), y_std=torch.ones(3))
    z = t_filters.APPLY[ftype](raw, q)
    got = t_filters.APPLY[ftype](_torch(p), q)
    want = z * torch.from_numpy(p["y_std"])[:, None] \
        + torch.from_numpy(p["y_mean"])[:, None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)


@pytest.mark.parametrize("ftype,kw", [("cnn", {}), ("cnn", {"channels": 24,
                                                             "ksize": 5}),
                                      ("rnn", {}), ("rnn", {"hidden": 32})],
                         ids=["cnn", "cnn-c24-k5", "rnn", "rnn-h32"])
def test_init_shapes_and_scales(ftype, kw):
    """The port's init gives the reference's shapes, zero bias, identity
    statistics, and normal draws at the reference's scales."""
    F, m = 16, 32
    want = filters.INIT[ftype](jax.random.PRNGKey(0), F, m, **kw)
    got = t_filters.INIT[ftype](F, m, **kw, generator=torch.Generator()
                                .manual_seed(0), device="cpu")
    assert set(got) == set(want)
    for name, v in want.items():
        v = np.asarray(v)
        assert tuple(got[name].shape) == v.shape, name
        assert got[name].dtype == torch.float32, name
        if name in ("b", "y_mean", "y_std"):
            np.testing.assert_array_equal(got[name].numpy(), v)
            continue
        scale = float(np.std(v))            # the reference's draw's spread
        assert abs(got[name].std().item() / scale - 1) < 0.1, name
        assert abs(got[name].mean().item()) < 0.1 * scale, name
    if ftype == "cnn":
        K = kw.get("ksize", 3)
        C = kw.get("channels", m)
        want_scale = {"c1": np.sqrt(2 / K), "c2": np.sqrt(2 / (K * C)),
                      "w": np.sqrt(1 / C)}
    else:
        h = kw.get("hidden", 64)
        want_scale = {k: np.sqrt(1 / h)
                      for k in ("wi1", "wh1", "wi2", "wh2", "w")}
    for name, s in want_scale.items():
        assert abs(got[name].std().item() / s - 1) < 0.1, name


# ---------------------------------------------------------------------------
# through search, on carried indexes
# ---------------------------------------------------------------------------


def _dstree_config(mod, training):
    return mod.LeaFiConfig(backbone="dstree", leaf_capacity=64, n_global=60,
                           n_local=16, t_filter_over_t_series=10.0,
                           train=training.TrainConfig(epochs=5))


#: the backbones' widths at m = 96 (kept small: the reference runs them in
#: XLA on the CPU)
WIDTHS = {"cnn": {"channels": 16, "ksize": 3}, "rnn": {"hidden": 16}}


def _swap_filters(mlp_lfi, ftype):
    """The reference index with its MLP stack replaced by a ``ftype`` stack
    (the MLP's y_mean and y_std kept) and its tuner refit on its own
    predictions over the calibration split."""
    F, m = len(mlp_lfi.leaf_ids), mlp_lfi.index.length
    params = filters.INIT[ftype](jax.random.PRNGKey(3), F, m,
                                 **WIDTHS[ftype])
    params["y_mean"] = mlp_lfi.filter_params["y_mean"]
    params["y_std"] = mlp_lfi.filter_params["y_std"]
    cal = mlp_lfi.calib
    d_pred = search.predictions_for_all_leaves(
        mlp_lfi.index, params, mlp_lfi.leaf_ids, jnp.asarray(cal.queries),
        None, filter_type=ftype)
    tuner, _ = conformal.fit_autotuners(
        d_lb=cal.d_lb, d_pred=np.asarray(d_pred), d_L=cal.d_L,
        leaf_ids=mlp_lfi.leaf_ids)
    return dataclasses.replace(
        mlp_lfi, filter_params=params, tuner=tuner,
        config=dataclasses.replace(mlp_lfi.config, filter_type=ftype))


@pytest.fixture(scope="module", params=["dstree", "isax"])
def mlp_built(request, randwalk_small):
    config = _dstree_config if request.param == "dstree" else isax_config
    ref = build.build_leafi(randwalk_small[:1500],
                            config(build, filter_training))
    assert len(ref.leaf_ids) > 4
    return ref


@pytest.fixture(scope="module", params=["cnn", "rnn"])
def built(request, mlp_built):
    ref = _swap_filters(mlp_built, request.param)
    return ref, carry(ref)


def test_bridge_infers_the_filter_type(built):
    ref, port = built
    assert port.config.filter_type == ref.config.filter_type
    assert port.config.weight_dtype == "float32"
    assert set(port.filter_params) == set(ref.filter_params)
    assert all(v.dtype == torch.float32
               for v in port.filter_params.values())


def test_bridge_keeps_mlp_indexes_mlp(mlp_built):
    port = carry(mlp_built)
    assert port.config.filter_type == "mlp"
    assert t_filters.filter_type_of(port.filter_params) == "mlp"


@pytest.mark.parametrize("offsets", ["none", "shared", "per-query"])
def test_predictions_for_all_leaves_match_reference(built, queries_small,
                                                    offsets):
    """Every other filter only, so that half the leaves carry none."""
    ref, port = built
    ftype = ref.config.filter_type
    q = queries_small[:12]
    off = {"none": None,
           "shared": ref.tuner.offsets(0.95),
           "per-query": ref.tuner.offsets(
               np.random.default_rng(0).choice([0.9, 0.99], len(q)))}[offsets]
    off = None if off is None else np.ascontiguousarray(off[..., ::2])
    leaf_ids = ref.leaf_ids[::2]
    want = np.asarray(search.predictions_for_all_leaves(
        ref.index, {k: v[::2] for k, v in ref.filter_params.items()},
        leaf_ids, jnp.asarray(q), off, filter_type=ftype))
    got = t_search.predictions_for_all_leaves(
        port.index, {k: v[::2].contiguous()
                     for k, v in port.filter_params.items()},
        leaf_ids, torch.from_numpy(q), off, filter_type=ftype).numpy()
    assert got.shape == want.shape == (len(q), port.index.n_leaves)
    unfiltered = np.setdiff1d(np.arange(port.index.n_leaves), leaf_ids)
    assert len(unfiltered) > 0
    assert np.isneginf(got[:, unfiltered]).all()
    assert np.isfinite(got[:, leaf_ids]).all()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


def _same(got, want):
    np.testing.assert_array_equal(got.ids, want.ids)
    for name in ("searched", "pruned_lb", "pruned_filter"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    np.testing.assert_allclose(got.dists, want.dists, **TOL)


@pytest.mark.parametrize("strategy", ["compact", "scan"])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("target", [None, 0.99], ids=str)
def test_search_matches_reference(built, queries_small, strategy, k,
                                  target):
    ref, port = built
    q = queries_small[:16]
    want = ref.search(q, k=k, quality_target=target)
    got = port.search(q, k=k, quality_target=target, strategy=strategy,
                      device="cpu")
    _same(got, want)
    if target is None:
        assert got.pruned_filter.sum() == 0


def test_grouped_matches_reference(built, queries_small):
    ref, port = built
    q = queries_small[:12]
    targets = np.random.default_rng(11).permutation(
        np.repeat([0.9, 0.99], len(q) // 2))
    kw = dict(filter_type=ref.config.filter_type, strategy="scan")
    want = search.search_batched_grouped(
        ref.index, q, targets, k=5, filter_params=ref.filter_params,
        leaf_ids=ref.leaf_ids, tuner=ref.tuner, **kw)
    got = t_search.search_batched_grouped(
        port.index, q, targets, k=5, filter_params=port.filter_params,
        leaf_ids=port.leaf_ids, tuner=port.tuner, device="cpu", **kw)
    _same(got, want)


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("target", [None, 0.99], ids=str)
def test_search_early_matches_reference(built, queries_small, k, target):
    ref, port = built
    ftype = ref.config.filter_type
    for qi in range(4):
        kw = dict(k=k, quality_target=target, use_filters=target is not None,
                  filter_type=ftype)
        want = search.search_early(
            ref.index, queries_small[qi], filter_params=ref.filter_params,
            leaf_ids=ref.leaf_ids, tuner=ref.tuner, **kw)
        got = t_search.search_early(
            port.index, queries_small[qi], filter_params=port.filter_params,
            leaf_ids=port.leaf_ids, tuner=port.tuner, device="cpu", **kw)
        _same(got, want)


def test_filter_type_reaches_the_backbone(built, queries_small, monkeypatch):
    """``LeaFiIndex.search`` takes the config's filter type; a keyword
    overrides it (here: the MLP on a CNN/LSTM stack fails)."""
    _, port = built
    ftype = port.config.filter_type
    seen = []
    fn = t_filters.APPLY[ftype]
    monkeypatch.setitem(t_filters.APPLY, ftype,
                        lambda p, q: seen.append(q.shape) or fn(p, q))
    port.search(queries_small[:3], quality_target=0.99, device="cpu")
    assert seen == [(3, port.index.length)]
    with pytest.raises(KeyError):
        port.search(queries_small[:3], quality_target=0.99, device="cpu",
                    filter_type="mlp")


def test_build_refuses_other_filter_types(randwalk_small):
    for ftype in ("cnn", "rnn"):
        with pytest.raises(NotImplementedError, match="MLP-only"):
            t_build.build_leafi(randwalk_small[:500],
                                t_build.LeaFiConfig(filter_type=ftype),
                                device="cpu")


def test_filter_type_of():
    gen = torch.Generator().manual_seed(0)
    for ftype in ("mlp", "cnn", "rnn"):
        p = t_filters.INIT[ftype](2, 8, generator=gen, device="cpu")
        assert t_filters.filter_type_of(p) == ftype


# ---------------------------------------------------------------------------
# build_dstree's and build_isax's options
# ---------------------------------------------------------------------------


def _assert_same_tree(got, ref):
    for name in ("order", "leaf_start", "leaf_size"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert got.max_leaf_size == ref.max_leaf_size
    assert (got.n_series, got.length) == (ref.n_series, ref.length)
    np.testing.assert_allclose(got.series.numpy(), np.asarray(ref.series),
                               rtol=1e-6, atol=1e-6)
    assert set(got.payload) == set(ref.payload)
    for name, v in ref.payload.items():
        v, g = np.asarray(v), got.payload[name].numpy()
        if v.dtype.kind == "f":
            np.testing.assert_array_equal(np.isinf(g), np.isinf(v))
            fin = np.isfinite(v)
            # the SAX edges to the breakpoints' 2 ulp, the EAPCA boxes as
            # ``test_torch_index.py`` holds them
            tol = (dict(rtol=0, atol=2.4e-7) if name == "sax_edges"
                   else dict(rtol=1e-6, atol=1e-6))
            np.testing.assert_allclose(g[fin], v[fin], **tol)
        else:
            np.testing.assert_array_equal(g, v)


@pytest.mark.parametrize("znorm", [False, True])
def test_build_dstree_znorm_matches_reference(randwalk_small, znorm):
    S = randwalk_small[:2000]
    ref = tree.build_dstree(S, leaf_capacity=64, znorm=znorm)
    got = t_tree.build_dstree(S, leaf_capacity=64, znorm=znorm)
    _assert_same_tree(got, ref)
    if not znorm:                       # the series as given
        np.testing.assert_array_equal(
            got.series.numpy()[:got.n_series], S[got.order.numpy()])


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("znorm", [False, True])
def test_build_isax_options_match_reference(randwalk_small, bits, znorm):
    S = randwalk_small[:2000]
    ref = tree.build_isax(S, leaf_capacity=64, max_card_bits=bits,
                          znorm=znorm)
    got = t_tree.build_isax(S, leaf_capacity=64, max_card_bits=bits,
                            znorm=znorm)
    _assert_same_tree(got, ref)
    assert got.payload["sax_bits"].max().item() <= bits


def test_sax_symbol_edges_takes_max_bits():
    rng = np.random.default_rng(0)
    card = rng.integers(0, 5, (30, 8))
    sym = rng.integers(0, 1 << 4, (30, 8)) >> (4 - card)
    got = t_summaries.sax_symbol_edges(sym, card, max_bits=4)
    want = summaries.sax_symbol_edges(sym, card, max_bits=4)
    np.testing.assert_array_equal(got, t_summaries.sax_symbol_edges(sym,
                                                                    card))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)


# ---------------------------------------------------------------------------
# the chip check's filter-types phase, rehearsed
# ---------------------------------------------------------------------------


def test_chip_smoke_filter_types_rehearsal_on_cpu(capsys):
    """``run_filter_types`` as ``chip_smoke.py`` drives it, at a tiny size
    on the CPU (where no kernel launches); its ragged calls' plain versions
    give finite (F, Q) predictions; the bounds count the issue's work."""
    smoke = _load_smoke()
    out = smoke.run_end_to_end(n=2000, m=64, n_queries=16, n_brute=8,
                               leaf_capacity=64, n_global=60, n_local=16,
                               epochs=3, device="cpu")
    ft = smoke.run_filter_types(
        out["lfi"], out["queries"], n_search=8, n_early=2,
        widths={"cnn": {"channels": 8, "ksize": 3}, "rnn": {"hidden": 8}},
        device="cpu")
    assert set(ft["launches"]) == set(smoke.KERNELS)
    for ftype in ("cnn", "rnn"):
        assert set(ft[ftype]["results"]) == {(k, t) for k in (1, 5)
                                             for t in ("exact", "0.99")}
        assert ft[ftype]["early"].dists.shape == (2, 5)
    printed = capsys.readouterr().out
    for ftype in ("cnn", "rnn"):
        assert f"filter type {ftype}" in printed
        assert "search_early k=5 target=0.99" in printed
        assert "exact search == brute force on 2 queries" in printed
    assert set(smoke.FILTER_TYPES) == {"cnn", "rnn"}
    from repro_torch.kernels.filter_cnn import ref as cnn_ref
    from repro_torch.kernels.filter_rnn import ref as rnn_ref
    calls = smoke.filter_type_calls("cpu")
    assert len(calls["filter_cnn"]) == len(smoke.RAGGED_CNN)
    for call, (F, Q, m, C, K) in zip(calls["filter_cnn"], smoke.RAGGED_CNN):
        assert tuple(call[2].shape) == (F, K, C, C)
        got = cnn_ref.cnn_filter(*call)
        assert got.shape == (F, Q) and torch.isfinite(got).all()
    for call, (F, Q, m, h) in zip(calls["filter_rnn"][:-1],
                                  smoke.RAGGED_RNN[:-1]):
        assert tuple(call[2].shape) == (F, h, 4 * h)
        got = rnn_ref.lstm_filter(*call)
        assert got.shape == (F, Q) and torch.isfinite(got).all()
    q, c1 = torch.zeros(180, 256), torch.zeros(4096, 3, 1, 256)
    flops, _ = smoke._backbone_work("filter_cnn", (q[:1], c1[:1]))
    assert round(flops / 1e5) == 1012                # ~101.2 MFLOP a pair
    w = torch.zeros(4096, 64)
    flops, _ = smoke._backbone_work("filter_rnn",
                                    (q[:1], None, None, None, None, w[:1]))
    assert flops == 256 * 98_816 + 128               # 98,816 a step
    ms, by = smoke._bound("filter_cnn", (q, c1))
    assert by == "operations" and 1100 < ms < 1120   # ~1.11 s
    assert smoke._reps(ms) == 1 and smoke._reps(0.5) == 20


def _meta_stack(ftype, F=2, Q=3, m=8, width=4):
    meta = dict(device="meta")
    q = torch.empty((Q, m), **meta)
    head = tuple(torch.empty(F, **meta) for _ in range(3))
    if ftype == "cnn":
        return (q, torch.empty((F, 3, 1, width), **meta),
                torch.empty((F, 3, width, width), **meta),
                torch.empty((F, width), **meta)) + head
    return (q, torch.empty((F, 1, 4 * width), **meta)) + tuple(
        torch.empty((F, width, 4 * width), **meta) for _ in range(3)) + (
        torch.empty((F, width), **meta),) + head


@pytest.mark.parametrize("ftype", ["cnn", "rnn"])
def test_wrappers_never_fall_back_off_the_cpu(ftype):
    """A stack that does not lie on the CPU goes to the CUDA kernel: here,
    without CUDA, that raises instead of running the plain version; a stack
    of the wrong shapes is refused before any launch."""
    from repro_torch.kernels.filter_cnn import kernel as cnn_kernel
    from repro_torch.kernels.filter_rnn import kernel as rnn_kernel
    entry = (cnn_kernel.cnn_filter if ftype == "cnn"
             else rnn_kernel.lstm_filter)
    args = _meta_stack(ftype)
    with pytest.raises(RuntimeError):
        entry(*args)
    bad = list(args)
    bad[-4] = torch.empty((5, bad[-4].shape[1]), device="meta")   # w
    with pytest.raises(ValueError, match="stack"):
        entry(*bad)
    bad = list(args)
    bad[-1] = torch.empty(7, device="meta")                        # y_std
    with pytest.raises(ValueError, match="y_std"):
        entry(*bad)
