"""The port's filter-inference suite against the JAX package's, on the CPU.

The per-filter sweep's wrapper (``ops.filter_predict``, the plain version
for CPU tensors) against the reference's Pallas kernel in interpret mode at
a ragged shape, to 1e-5 (f32 sums in another order); the port's analytic
roofline against the reference's under the same hardware numbers, for both
variants and all three payloads, exact (the same integer counts divided by
the same rates); and ``bench_filters`` at a tiny sweep: the reference
suite's payload keys, every parity error within 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import filters_bench as ref_bench
from repro.analysis import roofline as ref_roofline
from repro.kernels.filter_mlp import ops as mlp_ops
from repro_torch.analysis import roofline
from repro_torch.bench import filters_bench
from repro_torch.kernels.filter_mlp import kernel as t_mlp_kernel
from repro_torch.kernels.filter_mlp import ops as t_mlp_ops
from _torch_threads import one_torch_thread  # noqa: F401


def _stack(rng, F, m, h):
    f32 = np.float32
    return ((rng.standard_normal((F, m, h)) * 0.2).astype(f32),
            (rng.standard_normal((F, h)) * 0.1).astype(f32),
            (rng.standard_normal((F, h)) * 0.2).astype(f32),
            rng.standard_normal((F,)).astype(f32))


@pytest.mark.parametrize("F,Q,m,h", [(5, 20, 24, 16), (1, 1, 8, 8),
                                     (3, 130, 96, 72)])
def test_filter_predict_matches_reference(F, Q, m, h):
    rng = np.random.default_rng(F * 100 + Q)
    w1, b1, w2, b2 = _stack(rng, F, m, h)
    q = rng.standard_normal((Q, m)).astype(np.float32)
    want = np.asarray(mlp_ops.filter_predict(
        *(jnp.asarray(a) for a in (w1, b1, w2, b2, q)), interpret=True))
    got = t_mlp_ops.filter_predict(
        *(torch.from_numpy(a) for a in (w1, b1, w2, b2, q)))
    assert got.shape == (F, Q) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_filter_predict_never_falls_back_off_the_cpu():
    """A tensor off the CPU goes to the kernel: without CUDA that raises,
    and the launch counter does not move."""
    before = t_mlp_kernel.LAUNCHES["filter_mlp"]
    q = torch.empty((4, 8), device="meta")
    with pytest.raises(RuntimeError):
        t_mlp_ops.filter_predict(torch.empty((2, 8, 8), device="meta"),
                                 torch.empty((2, 8), device="meta"),
                                 torch.empty((2, 8), device="meta"),
                                 torch.empty((2,), device="meta"), q)
    assert t_mlp_kernel.LAUNCHES["filter_mlp"] == before


@pytest.mark.parametrize("variant", ["per_filter", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", [(4096, 128, 128, 128), (4096, 256, 256,
                                                           256),
                                   (7, 5, 33, 20)], ids=str)
def test_roofline_matches_reference(variant, dtype, shape):
    hw = roofline.H100
    ref_hw = ref_roofline.HardwareSpec(hw.name, peak_flops=hw.peak_flops,
                                       hbm_bw=hw.hbm_bw, ici_bw=1.0)
    F, Q, m, h = shape
    want = ref_roofline.filter_mlp_roofline(
        F, Q, m, h, variant=variant, weight_dtype=dtype, bq=roofline.BQ,
        bf=roofline.BF, hw=ref_hw)
    got = roofline.filter_mlp_roofline(F, Q, m, h, variant=variant,
                                       weight_dtype=dtype)
    assert want.t_collective == 0.0       # the term the port leaves out
    for name in ("flops_per_device", "hbm_bytes_per_device", "t_compute",
                 "t_memory", "bound_time"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.dominant == want.dominant
    assert set(got.as_dict()) <= set(want.as_dict())


def test_roofline_rejects_an_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        roofline.filter_mlp_roofline(8, 8, 8, 8, variant="nope")


def test_h100_bound_at_the_suites_largest_shape():
    """F = 4096, Q = 128, m = h = 128: 1.73e10 operations over 67 TFLOP/s
    outweigh the per-filter composition's bytes over 3.35 TB/s."""
    r = roofline.filter_mlp_roofline(4096, 128, 128, 128,
                                     variant="per_filter")
    assert r.dominant == "compute"
    assert r.flops_per_device == 4096 * 128 * (2 * 128 * 128 + 2 * 128) \
        == roofline.mlp_operations(4096, 128, 128, 128)
    np.testing.assert_allclose(r.bound_time, 2.584e-4, rtol=1e-3)


def test_bench_filters_payload_matches_reference_keys():
    sweep = dict(f_values=(3, 9), q=20, m=24, h=16)
    rows, payload = filters_bench.bench_filters(**sweep, device="cpu")
    _, want = ref_bench.bench_filters(**sweep)
    assert set(payload) == set(want)
    assert set(payload["parity_max_abs_err"]) == \
        set(want["parity_max_abs_err"])
    for err in payload["parity_max_abs_err"].values():
        assert err <= 1e-5
    assert set(payload["fused_speedup_f32"]) == {"3", "9"}
    assert payload["config"]["hw"] == roofline.H100.name
    assert payload["config"]["device"] == "cpu"
    # the same cases, each with the reference's roofline at the same shape
    assert len(payload["results"]) == len(want["results"]) == len(rows) == 8
    for got, ref in zip(payload["results"], want["results"]):
        for key in ("F", "Q", "m", "h", "impl", "weight_dtype"):
            assert got[key] == ref[key]
        assert got["roofline"]["flops_per_device"] == \
            ref["roofline"]["flops_per_device"]
        assert got["roofline"]["hbm_bytes_per_device"] == \
            ref["roofline"]["hbm_bytes_per_device"]
        assert got["us_per_call"] > 0


def test_timed_reads_the_host_clock_on_the_cpu():
    """One warm-up call, then ``repeat`` timed calls; the last output."""
    calls = []

    def fn():
        calls.append(1)
        return torch.full((2,), float(len(calls)))

    out, sec = filters_bench.timed(fn, torch.device("cpu"), repeat=3)
    assert len(calls) == 4 and out.tolist() == [4.0, 4.0]
    assert sec >= 0
