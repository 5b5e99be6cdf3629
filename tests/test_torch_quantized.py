"""The port's bf16/int8 filter payloads against the JAX package's, on the
CPU.

``quantize_mlp`` is bitwise the reference's (payloads and scales).  A
reference-built iSAX index, after the reference's ``requantize_leafi`` to
bfloat16 and int8, is carried across by ``repro_torch.bridge`` and answers
with the reference's ids and searched/pruned counters exactly, distances
within 1e-5, at exact, 0.9, 0.95, 0.99 and per-query targets, k = 1 and 5.
The port's own ``requantize_leafi`` on the carried float32 index (with its
calibration split) refits the same tuners and gives the same answers.  The
reference's iSAX quantized-recall assertion (tests/test_filters.py), which
fails on the reference itself, is not copied: the port is held to the
reference's outputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build, filter_training, filters
from repro_torch.core import build as t_build
from repro_torch.core import filter_training as t_training
from repro_torch.core import filters as t_filters
from test_torch_isax import (TARGETS, assert_same_answers, carry,
                             isax_config, target)
from _torch_threads import one_torch_thread  # noqa: F401

PAYLOADS = ["bfloat16", "int8"]


def _stack(seed=0, F=6, m=48, h=32):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.standard_normal((F, m, h)) * 0.2).astype(np.float32),
            "b1": rng.standard_normal((F, h)).astype(np.float32),
            "w2": (rng.standard_normal((F, h)) * 0.3).astype(np.float32),
            "b2": rng.standard_normal(F).astype(np.float32),
            "y_mean": rng.standard_normal(F).astype(np.float32),
            "y_std": np.abs(rng.standard_normal(F)).astype(np.float32)}


def _bits(a):
    """A JAX or torch array's raw bytes as numpy, for bitwise comparison."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("weight_dtype", ["float32"] + PAYLOADS)
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_mlp_is_bitwise_the_reference(weight_dtype, seed):
    p = _stack(seed)
    p["w1"][0, 0, :3] = [0.0, -1e-9, 3.0]      # a zero, a tiny value, the max
    want = filters.quantize_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                weight_dtype)
    got = t_filters.quantize_mlp({k: torch.from_numpy(v.copy())
                                  for k, v in p.items()}, weight_dtype)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=k)
    assert t_filters.mlp_weight_dtype(got) == weight_dtype
    # a quantized input is dequantized first, then re-quantized
    for other in PAYLOADS:
        want2 = filters.quantize_mlp(want, other)
        got2 = t_filters.quantize_mlp(got, other)
        for k in want2:
            np.testing.assert_array_equal(_bits(got2[k]), _bits(want2[k]),
                                          err_msg=f"{weight_dtype}->{other}"
                                          f" {k}")


def test_quantized_param_bytes_match_the_accounting():
    F, m, h = 5, 48, 32
    for dtype in ["float32"] + PAYLOADS:
        q = t_filters.quantize_mlp({k: torch.from_numpy(v) for k, v in
                                    _stack(F=F, m=m, h=h).items()}, dtype)
        nbytes = sum(v.numel() * v.element_size() for v in q.values())
        assert nbytes == F * t_filters.mlp_param_bytes(m, h, dtype)
        assert t_filters.mlp_param_bytes(m, h, dtype) == \
            filters.mlp_param_bytes(m, h, dtype)


@pytest.fixture(scope="module")
def built(randwalk_small):
    ref = build.build_leafi(randwalk_small[:1500],
                            isax_config(build, filter_training))
    port32 = carry(ref, with_calib=True)
    out = {}
    for dtype in PAYLOADS:
        rq = build.requantize_leafi(ref, dtype)
        out[dtype] = (rq, carry(rq),
                      t_build.requantize_leafi(port32, dtype,
                                               device="cpu"))
    return out


@pytest.mark.parametrize("weight_dtype", PAYLOADS)
def test_bridge_keeps_the_payload(built, weight_dtype):
    ref, port, _ = built[weight_dtype]
    assert port.config.weight_dtype == weight_dtype
    for k, v in ref.filter_params.items():
        np.testing.assert_array_equal(_bits(port.filter_params[k]), _bits(v),
                                      err_msg=k)


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("qt", TARGETS, ids=str)
@pytest.mark.parametrize("weight_dtype", PAYLOADS)
def test_carried_quantized_index_matches_reference(built, queries_small,
                                                   weight_dtype, k, qt):
    ref, port, _ = built[weight_dtype]
    got = assert_same_answers(port, ref, queries_small, k,
                              target(qt, len(queries_small)))
    if qt == 0.95:
        assert got.pruned_filter.sum() > 0


@pytest.mark.parametrize("weight_dtype", PAYLOADS)
def test_port_requantize_matches_reference(built, queries_small,
                                           weight_dtype):
    ref, _, port = built[weight_dtype]
    assert port.config.weight_dtype == weight_dtype
    for k, v in ref.filter_params.items():
        np.testing.assert_array_equal(_bits(port.filter_params[k]), _bits(v),
                                      err_msg=k)
    np.testing.assert_array_equal(port.tuner.knots_q, ref.tuner.knots_q)
    np.testing.assert_allclose(port.tuner.knots_o, ref.tuner.knots_o,
                               rtol=1e-5, atol=1e-6)
    for qt in (None, 0.95, 0.99, target("per-query", len(queries_small))):
        assert_same_answers(port, ref, queries_small, 1, qt)


def test_port_build_and_requantize_end_to_end(randwalk_small,
                                              queries_small):
    ref = build.build_leafi(randwalk_small[:1500],
                            isax_config(build, filter_training))
    cfg = isax_config(t_build, t_training)
    cfg.weight_dtype = "int8"
    lfi = t_build.build_leafi(randwalk_small[:1500], cfg, device="cpu")
    np.testing.assert_array_equal(lfi.leaf_ids, ref.leaf_ids)
    assert t_filters.mlp_weight_dtype(lfi.filter_params) == "int8"
    for dtype in ["bfloat16", "float32"]:
        lq = t_build.requantize_leafi(lfi, dtype, device="cpu")
        assert t_filters.mlp_weight_dtype(lq.filter_params) == dtype
        assert lq.index is lfi.index
        r = lq.search(queries_small, k=1, quality_target=0.99, device="cpu")
        assert np.isfinite(r.dists).all()
        assert (r.searched + r.pruned_lb + r.pruned_filter
                == lq.index.n_leaves).all()
