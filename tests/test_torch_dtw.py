"""The port's DTW (``repro_torch.core.dtw``) against the reference's
(``repro.core.dtw``) on the CPU: the banded DTW bitwise (alone and under
``jax.vmap``), the Keogh envelope bitwise, both LB_Keogh forms within
1e-6 (their sums run in another order, through ``box_lb``), the
reference tests' invariants on the port, the register instance of
``csrc/dtw.cu`` emulated bitwise against the plain loop, the kernel's
bound, its wrappers' refusals, and ``chip_smoke.run_dtw`` rehearsed."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _torch_threads import one_torch_thread  # noqa: F401
from test_dtw import dtw_oracle
from test_torch_isolation import PORT, _load_smoke

from repro.core import dtw as ref_dtw
from repro_torch.core import dtw
from repro_torch.kernels.dtw import kernel as dtw_kernel
from repro_torch.kernels.dtw import ref as dtw_ref

CASES = [(m, band) for m in (8, 16, 33, 256)
         for band in (0, 2, 8, m - 1, m + 5)]


def _series(rng, n: int, m: int) -> np.ndarray:
    """Random walks, one row rounded to halves (ties), one with a repeated
    run of values, one constant."""
    w = rng.standard_normal((n, m)).cumsum(1).astype(np.float32)
    w[0] = np.round(w[0] * 2) / 2
    if n > 1:
        w[1, m // 4: m // 2 + 1] = w[1, m // 4]
    if n > 2:
        w[2] = 1.5
    return w


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_all_pairs(q: np.ndarray, x: np.ndarray, band: int) -> np.ndarray:
    pairs = jax.vmap(lambda a: jax.vmap(
        lambda b: ref_dtw.dtw(a, b, band=band))(jnp.asarray(x)))
    return np.asarray(pairs(jnp.asarray(q)))


@pytest.mark.parametrize("m,band", CASES)
def test_dtw_bitwise_against_reference(m, band):
    rng = np.random.default_rng(1000 * m + band)
    q, x = _series(rng, 3, m), _series(rng, 4, m)
    x[3] = q[0]                               # a pair at distance 0
    want = _ref_all_pairs(q, x, band)
    got = dtw.dtw(_t(q), _t(x), band=band)
    assert got.dtype == torch.float32 and got.shape == (3, 4)
    assert np.array_equal(got.numpy(), want)
    assert got[0, 3].item() == 0.0
    # one pair, and one side batched: the reference alone and under vmap
    single = dtw.dtw(_t(q[1]), _t(x[2]), band=band)
    assert single.shape == () and np.array_equal(
        single.numpy(), np.asarray(ref_dtw.dtw(jnp.asarray(q[1]),
                                               jnp.asarray(x[2]), band=band)))
    rows = dtw.dtw(_t(q[1]), _t(x), band=band)
    assert rows.shape == (4,) and np.array_equal(rows.numpy(), want[1])
    cols = dtw.dtw(_t(q), _t(x[2]), band=band)
    assert cols.shape == (3,) and np.array_equal(cols.numpy(), want[:, 2])


def test_dtw_default_band_is_the_reference_default():
    rng = np.random.default_rng(7)
    q, x = _series(rng, 1, 40)[0], _series(rng, 1, 40)[0]
    assert np.array_equal(dtw.dtw(_t(q), _t(x)).numpy(),
                          np.asarray(ref_dtw.dtw(jnp.asarray(q),
                                                 jnp.asarray(x))))


def test_batched_dtw_equals_a_loop_of_single_calls():
    rng = np.random.default_rng(3)
    q, x = _series(rng, 4, 33), _series(rng, 5, 33)
    got = dtw.dtw(_t(q), _t(x), band=3)
    loop = torch.stack([torch.stack([dtw.dtw(_t(a), _t(b), band=3)
                                     for b in x]) for a in q])
    assert torch.equal(got, loop)


@pytest.mark.parametrize("m,band", [(1, 0), (1, 8), (8, 0), (8, 2), (33, 8),
                                    (33, 40), (256, 8), (256, 300)])
def test_keogh_envelope_bitwise(m, band):
    rng = np.random.default_rng(m + band)
    q = _series(rng, 3, m)
    lo, hi = dtw.keogh_envelope(_t(q), band)
    want_lo, want_hi = jax.vmap(lambda a: ref_dtw.keogh_envelope(a, band))(
        jnp.asarray(q))
    assert np.array_equal(lo.numpy(), np.asarray(want_lo))
    assert np.array_equal(hi.numpy(), np.asarray(want_hi))
    one_lo, one_hi = dtw.keogh_envelope(_t(q[0]), band)
    assert one_lo.shape == (m,) and torch.equal(one_lo, lo[0])
    assert torch.equal(one_hi, hi[0])


@pytest.mark.parametrize("m,band", [(8, 2), (33, 8), (256, 8), (24, 30)])
def test_lb_keogh_against_reference(m, band):
    rng = np.random.default_rng(m * band)
    q, x = _series(rng, 3, m), _series(rng, 5, m)
    want = np.asarray(jax.vmap(lambda a: jax.vmap(
        lambda b: ref_dtw.lb_keogh(a, b, band=band))(jnp.asarray(x)))(
            jnp.asarray(q)))
    got = dtw.lb_keogh(_t(q), _t(x), band=band)
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dtw.lb_keogh(_t(q[0]), _t(x[1]),
                                            band=band).numpy(), want[0, 1],
                               rtol=1e-6, atol=1e-6)
    assert dtw.lb_keogh(_t(q[0]), _t(x), band=band).shape == (5,)
    assert dtw.lb_keogh(_t(q), _t(x[0]), band=band).shape == (3,)


@pytest.mark.parametrize("m", [16, 256])
def test_lb_keogh_leaves_against_reference(m):
    rng = np.random.default_rng(m)
    q = _series(rng, 4, m)
    members = _series(rng, 12, m)
    lo, hi = dtw.keogh_envelope(_t(members), 3)
    env_lo = torch.stack([lo[i::3].min(0).values for i in range(3)])
    env_hi = torch.stack([hi[i::3].max(0).values for i in range(3)])
    want = np.asarray(jax.vmap(lambda a: ref_dtw.lb_keogh_leaves(
        a, jnp.asarray(env_lo.numpy()), jnp.asarray(env_hi.numpy())))(
            jnp.asarray(q)))
    got = dtw.lb_keogh_leaves(_t(q), env_lo, env_hi)
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    one = dtw.lb_keogh_leaves(_t(q[2]), env_lo, env_hi)
    assert one.shape == (3,)
    np.testing.assert_allclose(one.numpy(), want[2], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the reference tests' invariants (tests/test_dtw.py), on the port
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), m=st.sampled_from([8, 16, 33]),
       band=st.sampled_from([2, 4, 8]))
def test_dtw_matches_the_reference_tests_oracle(seed, m, band):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(m).astype(np.float32)
    x = rng.standard_normal(m).astype(np.float32)
    got = float(dtw.dtw(_t(q), _t(x), band=band))
    np.testing.assert_allclose(got, dtw_oracle(q, x, band), rtol=1e-4,
                               atol=1e-4)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), band=st.sampled_from([2, 6]))
def test_lb_keogh_lower_bounds_dtw_and_dtw_bounds_euclidean(seed, band):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(24).astype(np.float32)
    x = rng.standard_normal(24).astype(np.float32)
    lb = float(dtw.lb_keogh(_t(q), _t(x), band=band))
    d = float(dtw.dtw(_t(q), _t(x), band=band))
    eu = float(np.sqrt(((q - x) ** 2).sum()))
    assert lb <= d + 1e-4, (lb, d)
    assert d <= eu + 1e-4, (d, eu)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_leaf_envelope_bound_underestimates_member_dtw(seed):
    rng = np.random.default_rng(seed)
    members = rng.standard_normal((6, 16)).astype(np.float32)
    q = rng.standard_normal(16).astype(np.float32)
    lo, hi = dtw.keogh_envelope(_t(members), 3)
    lb = dtw.lb_keogh_leaves(_t(q), lo.min(0).values[None],
                             hi.max(0).values[None])
    true = dtw.dtw(_t(q), _t(members), band=3).min()
    assert lb.shape == (1,) and lb[0] <= true + 1e-4, (lb, true)


# ---------------------------------------------------------------------------
# the kernel's design, emulated on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 2, 3, 9, 16, 17, 18, 33, 96])
def test_register_instance_emulated_equals_the_plain_loop(m):
    """The register instance's indexing (the window's slots (j + r) % W,
    rows in blocks of W = 2r + 1, the first block skipping columns < 0,
    zeros staged past column m - 1) gives the plain loop's values bitwise,
    NaN in an input included, at every band the table takes."""
    rng = np.random.default_rng(m)
    q, x = _series(rng, 3, m), _series(rng, 5, m)
    x[4, m // 2] = np.nan
    for band in sorted({0, 1, 2, 3, 4, 6, 8, m - 1, m + 5}):
        want = dtw_ref.dtw(_t(q), _t(x), band)
        got = dtw_ref.dtw_band_registers(_t(q), _t(x), band)
        assert torch.isnan(want[:, 4]).all()
        assert torch.equal(got[:, :4], want[:, :4]), (m, band)
        assert torch.isnan(got[:, 4]).all()


def test_bands_and_instances_match_the_source():
    src = (PORT / "csrc" / "dtw.cu").read_text()
    macro = re.search(r"#define DTW_BANDS\(X\) (.*)", src).group(1)
    assert tuple(int(b) for b in re.findall(r"X\((\d+)\)", macro)) == \
        dtw_kernel.BANDS
    assert dtw_kernel.BANDS == (2, 3, 4, 6, 8)
    assert dtw_kernel.instance(256, 8) == "band 8 in registers"
    assert dtw_kernel.instance(5, 8) == "band 4 in registers"   # r = m - 1
    assert dtw_kernel.instance(8, 5) == "any band (r = 5), frame in scratch"
    assert dtw_kernel.instance(256, 0).startswith("any band (r = 0)")
    assert dtw_kernel.instance(5, 3) == "band 3 in registers"
    for fn in ("__fsub_rn", "__fmul_rn", "__fadd_rn", "min.NaN.f32",
               "__fsqrt_rn"):
        assert fn in src


def test_in_band_cells_and_bound():
    for m in (1, 2, 8, 33, 256):
        for band in (0, 1, 3, 8, m - 1, m + 5):
            brute = sum(1 for i in range(m) for j in range(m)
                        if abs(i - j) <= band)
            assert dtw_ref.in_band_cells(m, band) == brute
    assert dtw_ref.in_band_cells(256, 8) == 4280
    ms, by = dtw_ref.bound(8, 1_000_000, 256, 8)
    assert by == "operations" and abs(ms - 6.1325) < 1e-3
    ms, by = dtw_ref.bound(1, 1_000_000, 256, 8)
    assert by == "operations" and abs(ms - 0.7666) < 1e-3
    # one series against one query at a narrow band: bytes bound it
    assert dtw_ref.bound(1, 1, 1, 0)[1] == "bytes"


# ---------------------------------------------------------------------------
# the wrappers' refusals
# ---------------------------------------------------------------------------


def test_wrappers_never_fall_back_off_the_cpu():
    """Tensors that do not lie on the CPU go to the CUDA kernels: here,
    without CUDA, that raises instead of running the plain versions."""
    q, x = torch.empty((2, 16), device="meta"), torch.empty((5, 16),
                                                            device="meta")
    with pytest.raises(RuntimeError):
        dtw.dtw(q, x)
    with pytest.raises(RuntimeError):
        dtw.lb_keogh(q, x)
    with pytest.raises(RuntimeError):
        dtw.lb_keogh_leaves(q, x, x)
    with pytest.raises(RuntimeError):
        dtw_kernel.dtw_cuda(q, x, 8)


def test_refusals_of_devices_dtypes_and_shapes():
    q, x = torch.zeros(2, 16), torch.zeros(5, 16)
    meta = torch.empty((5, 16), device="meta")
    for fn in (dtw.dtw, dtw.lb_keogh):
        with pytest.raises(ValueError, match="meta"):
            fn(q, meta)
        with pytest.raises(TypeError, match="float64"):
            fn(q.double(), x.double())
        with pytest.raises(TypeError, match="float64"):
            fn(q, x.double())
        with pytest.raises(TypeError, match="int64"):
            fn(q.long(), x)
        with pytest.raises(ValueError, match="length"):
            fn(q, torch.zeros(5, 15))
        with pytest.raises(ValueError, match="band"):
            fn(q, x, -1)
        with pytest.raises(ValueError, match="shape"):
            fn(torch.zeros(2, 3, 16), x)
    with pytest.raises(ValueError, match="meta"):
        dtw.lb_keogh_leaves(q, meta, meta)
    with pytest.raises(TypeError, match="float64"):
        dtw.lb_keogh_leaves(q, x.double(), x)
    with pytest.raises(ValueError, match="envelopes"):
        dtw.lb_keogh_leaves(q, x, x[:4])
    with pytest.raises(TypeError, match="float16"):
        dtw.keogh_envelope(q.half())
    with pytest.raises(ValueError, match="band"):
        dtw.keogh_envelope(q, -2)
    with pytest.raises(ValueError, match="match"):
        dtw_kernel.dtw_cuda(q, torch.zeros(5, 15), 8)
    with pytest.raises(ValueError, match="band"):
        dtw_kernel.dtw_cuda(q, x, -1)


# ---------------------------------------------------------------------------
# the chip check's DTW phase, rehearsed
# ---------------------------------------------------------------------------


def test_chip_smoke_dtw_rehearsal_on_cpu(capsys):
    """``run_dtw`` as ``chip_smoke.py`` drives it, at a tiny size on the
    CPU (where no kernel launches); its held calls' shapes; its bound."""
    smoke = _load_smoke()
    out = smoke.run_end_to_end(n=2000, m=64, n_queries=16, n_brute=8,
                               leaf_capacity=64, n_global=60, n_local=16,
                               epochs=3, device="cpu")
    captured: dict = {}
    res = smoke.run_dtw(out["lfi"], out["queries"], device="cpu",
                        captured=captured)
    assert not captured                   # no kernel is launched on the CPU
    assert set(res["launches"]) == set(smoke.KERNELS)
    assert res["pruned"].shape == (8,) and res["nn"].shape == (8,)
    assert ((res["pruned"] >= 0) & (res["pruned"] <= 1)).all()
    printed = capsys.readouterr().out
    assert "the DTW bitwise equal to its plain version on all 16000 pairs" \
        in printed
    assert "dtw query 7: DTW 1-NN" in printed
    assert "LB_Keogh alone prunes" in printed
    assert set(smoke.DTW_KERNELS) <= set(smoke.KERNELS)
    calls = smoke.dtw_calls("cpu")
    assert len(calls) == sum(2 * len(bands) for _, bands in smoke.RAGGED_DTW)
    instances = {dtw_kernel.instance(c[0].shape[1], c[2]).split(" (")[0]
                 for c in calls}
    assert instances == {"band 3 in registers", "band 8 in registers",
                         "any band"}
    for q, x, band in calls[:4]:
        assert x.shape[0] % 128 and q.shape[0] in (1, 8)
        assert torch.isfinite(dtw.dtw(q, x, band)).all()
    ms, by = smoke._bound("dtw", (torch.zeros(8, 256),
                                  torch.zeros(1_000_000, 256), 8))
    assert by == "operations" and abs(ms - 6.1325) < 1e-3
