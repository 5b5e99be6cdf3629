"""The port's knapsack selection and comparison-method simulators against
the JAX package's, on the CPU.

Both are host numpy, so the port's ``expected_benefit``,
``knapsack_select``, every simulator and every tuner must give the
reference's results exactly on the same seeded matrices.  The properties
the reference's own tests hold (``tests/test_baselines.py``,
``tests/test_selection.py``) are held for the port too, and
``chip_smoke.py``'s simulator phase is rehearsed at a tiny size.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st
from _torch_threads import one_torch_thread  # noqa: F401

from repro.core import baselines as j_baselines
from repro.core import selection as j_selection
from repro_torch.core import baselines, selection

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def sim_matrices():
    rng = np.random.default_rng(1)
    Q, L = 40, 80
    d_L = rng.uniform(1, 20, (Q, L)).astype(np.float32)
    d_lb = (d_L * rng.uniform(0.2, 0.95, (Q, L))).astype(np.float32)
    return d_lb, d_L


@pytest.fixture(scope="module")
def val_matrices():
    rng = np.random.default_rng(2)
    Q, L = 48, 80
    d_L = rng.uniform(1, 20, (Q, L)).astype(np.float32)
    d_lb = (d_L * rng.uniform(0.2, 0.95, (Q, L))).astype(np.float32)
    return d_lb, d_L


def _same_result(got, want):
    assert type(got).__name__ == type(want).__name__ == "SimResult"
    for f in ("searched", "bsf", "recall"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.n_leaves == want.n_leaves
    assert got.summary() == want.summary()


def _same_model(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, (f.name, a, b)


# -- selection ---------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(1, 60),
       cap=st.integers(0, 40))
def test_knapsack_and_benefit_equal_reference(seed, n, cap):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 2000, n)
    p_lb, p_f = rng.uniform(0, 1, n), rng.uniform(0, 1)
    t_s, t_f = float(rng.uniform(0.5, 2)), float(rng.uniform(1, 500))
    got_b = selection.expected_benefit(sizes, p_lb, p_f, t_s, t_f)
    want_b = j_selection.expected_benefit(sizes, p_lb, p_f, t_s, t_f)
    np.testing.assert_array_equal(got_b, want_b)
    weights = rng.integers(1, 8, n)
    got = selection.knapsack_select(got_b, weights, cap)
    want = j_selection.knapsack_select(want_b, weights, cap)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_threshold_matches_paper_formula():
    # paper §5.3.3: t_F/t_S ≈ 279 on Deep, a = 2 ⇒ th = 558
    assert selection.size_threshold(279.0, 1.0, a=2.0) == 558.0


@settings(max_examples=50, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 60),
       cap=st.integers(0, 30))
def test_greedy_is_optimal_for_uniform_weights(seed, n, cap):
    """Under the paper's assumption (uniform p_lb, p_F, w), value is
    monotone in leaf size, so greedy == exact knapsack value."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 2000, n)
    t_f, t_s, a = 30.0, 1.0, 2.0
    th = selection.size_threshold(t_f, t_s, a)
    values = selection.expected_benefit(sizes, p_lb=0.5, p_f=1 / a,
                                        t_series=t_s, t_filter=t_f)
    greedy = selection.greedy_select(sizes, th, max_filters=cap)
    exact = selection.knapsack_select(values, np.ones(n, np.int64), cap)
    assert np.isclose(values[greedy].clip(0).sum(),
                      values[exact].clip(0).sum())


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_knapsack_respects_capacity_and_beats_greedy_generally(seed):
    rng = np.random.default_rng(seed)
    n = 25
    values = rng.uniform(-1, 10, n)
    weights = rng.integers(1, 8, n)
    cap = 20
    picked = selection.knapsack_select(values, weights, cap)
    assert weights[picked].sum() <= cap
    assert (values[picked] > 0).all()
    order = np.argsort(-values / weights)
    w, v_greedy = 0, 0.0
    for i in order:
        if values[i] > 0 and w + weights[i] <= cap:
            w += weights[i]
            v_greedy += values[i]
    assert values[picked].sum() >= v_greedy - 1e-9


def test_negative_benefit_leaves_are_never_selected():
    sizes = np.asarray([10, 100, 1000])
    th = selection.size_threshold(60.0, 1.0, a=2.0)   # th = 120
    assert list(selection.greedy_select(sizes, th)) == [2]


# -- simulators and tuners against the reference -----------------------------


def test_plain_simulators_equal_reference(sim_matrices):
    d_lb, d_L = sim_matrices
    rng = np.random.default_rng(4)
    d_F = (d_L * rng.uniform(0.7, 1.2, d_L.shape)).astype(np.float32)
    thr = float(np.quantile(d_L.min(1), 0.5))
    for name, args in (("exact_search", (d_lb, d_L)),
                       ("leafi_search", (d_lb, d_L, d_F)),
                       ("leafi_search", (d_lb, d_L, d_L)),
                       ("epsilon_search", (d_lb, d_L, 0.5)),
                       ("epsilon_search", (d_lb, d_L, 2.0)),
                       ("delta_epsilon_search", (d_lb, d_L, thr)),
                       ("lr_optimal_search", (d_lb, d_L))):
        _same_result(getattr(baselines, name)(*args),
                     getattr(j_baselines, name)(*args))


@pytest.mark.parametrize("target", [0.9, 0.99])
def test_tuners_equal_reference(sim_matrices, val_matrices, target):
    d_lb, d_L = sim_matrices
    v_lb, v_L = val_matrices
    assert baselines.tune_epsilon(v_lb, v_L, target) == \
        j_baselines.tune_epsilon(v_lb, v_L, target)
    assert baselines.tune_delta(v_lb, v_L, target) == \
        j_baselines.tune_delta(v_lb, v_L, target)
    lt, j_lt = (baselines.train_lt(v_lb, v_L, target),
                j_baselines.train_lt(v_lb, v_L, target))
    _same_model(lt, j_lt)
    _same_result(baselines.lt_search(d_lb, d_L, lt),
                 j_baselines.lt_search(d_lb, d_L, j_lt))


@pytest.mark.parametrize("checkpoints", [(4, 8, 16), (16, 64, 256)])
def test_pros_equals_reference(sim_matrices, val_matrices, checkpoints):
    d_lb, d_L = sim_matrices
    v_lb, v_L = val_matrices
    pros = baselines.train_pros(v_lb, v_L, checkpoints=checkpoints)
    j_pros = j_baselines.train_pros(v_lb, v_L, checkpoints=checkpoints)
    _same_model(pros, j_pros)
    for threshold in (0.3, 0.5):
        _same_result(baselines.pros_search(d_lb, d_L, pros, threshold),
                     j_baselines.pros_search(d_lb, d_L, j_pros, threshold))


# -- the reference's properties, held for the port ---------------------------


def test_exact_search_full_recall(sim_matrices):
    d_lb, d_L = sim_matrices
    res = baselines.exact_search(d_lb, d_L)
    assert res.recall.mean() == 1.0
    np.testing.assert_allclose(res.bsf, d_L.min(1))


def test_epsilon_prunes_more_recall_may_drop(sim_matrices):
    d_lb, d_L = sim_matrices
    r0 = baselines.exact_search(d_lb, d_L)
    r2 = baselines.epsilon_search(d_lb, d_L, epsilon=2.0)
    assert r2.searched.mean() <= r0.searched.mean()
    assert (r2.bsf <= d_L.min(1) * 3.0 + 1e-5).all()


def test_lr_optimal_reordering_dominates_exact(sim_matrices):
    d_lb, d_L = sim_matrices
    r0 = baselines.exact_search(d_lb, d_L)
    r1 = baselines.lr_optimal_search(d_lb, d_L)
    assert r1.recall.mean() == 1.0
    assert r1.searched.mean() <= r0.searched.mean() + 1e-9


def test_leafi_sim_with_oracle_filters_is_optimal(sim_matrices):
    """Perfect filters (d_F = d_L): only leaves that improve the bsf are
    searched, no query searches more than exact, the answers are exact's."""
    d_lb, d_L = sim_matrices
    res = baselines.leafi_search(d_lb, d_L, d_F=d_L)
    base = baselines.exact_search(d_lb, d_L)
    assert res.recall.mean() == 1.0
    assert res.searched.mean() < base.searched.mean()
    assert (res.searched <= base.searched).all()
    np.testing.assert_array_equal(res.bsf, base.bsf)


def test_delta_epsilon_stops_early(sim_matrices):
    d_lb, d_L = sim_matrices
    thr = float(np.quantile(d_L.min(1), 0.5))
    res = baselines.delta_epsilon_search(d_lb, d_L, thr)
    base = baselines.exact_search(d_lb, d_L)
    assert res.searched.mean() <= base.searched.mean()


def test_pros_and_lt_train_and_run(sim_matrices):
    d_lb, d_L = sim_matrices
    pros = baselines.train_pros(d_lb, d_L, checkpoints=(4, 8, 16))
    r = baselines.pros_search(d_lb, d_L, pros)
    assert 0.0 <= r.recall.mean() <= 1.0
    lt = baselines.train_lt(d_lb, d_L, checkpoints=(1, 2, 4))
    assert baselines.lt_search(d_lb, d_L, lt).recall.mean() >= 0.5


def test_port_module_imports_nothing_of_the_reference():
    text = (ROOT / "src" / "repro_torch" / "core" / "baselines.py"
            ).read_text()
    assert "import repro." not in text and "from repro." not in text
    assert "import jax" not in text


# -- chip_smoke.py's simulator phase, rehearsed ------------------------------


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_simulator_phase_on_cpu(capsys):
    """The simulator phase as ``chip_smoke.py`` drives it, at a tiny size
    on the CPU: seven methods, its three invariants asserted, the walk's
    searched leaves printed beside the LeaFi simulator's."""
    smoke = _load_smoke()
    series = smoke.make_series(2000, 64)
    out = smoke.run_end_to_end(n=2000, m=64, n_queries=16, n_brute=8,
                               leaf_capacity=64, n_global=60, n_local=16,
                               epochs=3, device="cpu", series=series)
    res = smoke.run_simulators(out["lfi"], series, out["queries"], n_sim=16,
                               n_val=16, device="cpu")
    assert set(res["summary"]) == {"exact", "leafi", "eps", "deps", "pros",
                                   "lt", "lr"}
    assert res["summary"]["exact"]["recall"] == 1.0
    assert res["summary"]["lr"]["recall"] == 1.0
    assert res["walk_searched"] > 0 and res["wall_s"] > 0
    printed = capsys.readouterr().out
    for name in res["summary"]:
        assert f"simulator {name:5s} (target 0.99): recall=" in printed
    assert "the oracle filter searches" in printed
    assert "16 validation queries (the reference's benchmarks take 120" \
        in printed
