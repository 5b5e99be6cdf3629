"""The box lower bound beyond 64 dimensions.

A DSTree at n_segments EAPCA segments bounds in d = 2 x n_segments
dimensions, an iSAX index in d = word_len.  The JAX package's box kernel
takes any d (its BlockSpec spans the whole of d); the port's card kernel
once refused d > 64.  Here, on the CPU: the port's plain box bound
(``box_lb/ref.py``) and its lower bounds (``bounds.lower_bounds``) against
the reference's Pallas ``box_lb_kernel`` in interpret mode at d = 65 and
128; the wrapper's and the C entry's only limit on d is d >= 1; and a d =
128 DSTree build answers exact search equal to brute force.  The card run
(``chip_smoke.py``) holds the kernel at d = 65, 128 and 512 and builds a
d = 128 DSTree at 100,000 series.
"""
import importlib.util
import inspect
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.box_lb import ops as j_box_ops
from repro_torch.core import bounds, build, filter_training, summaries, tree
from repro_torch.kernels import common
from repro_torch.kernels.box_lb import kernel as box_kernel
from repro_torch.kernels.box_lb import ops as box_ops
from repro_torch.kernels.box_lb import ref as box_ref
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _series(n: int, m: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, m)).cumsum(1).astype(np.float32)


@pytest.mark.parametrize("d", [65, 128])
def test_plain_box_bound_matches_reference_kernel(d):
    """``box_lb/ref.py`` against the reference's Pallas kernel (interpret
    mode, padded by its wrapper) on boxes with open (+-inf) sides, an empty
    box and a NaN side, at d beyond the card kernel's old limit."""
    smoke = _load_smoke()
    q, lo, hi = smoke._box_args(np.random.default_rng(d), 37, 300, d, "cpu")
    want = np.asarray(j_box_ops.box_lb(
        *(jnp.asarray(a.numpy()) for a in (q, lo, hi)), interpret=True))
    got = box_ref.box_lb(q, lo, hi).numpy()
    assert got.shape == (37, 300) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backbone, width, m, d", [
    ("dstree", 64, 256, 128),       # 64 EAPCA segments: (mean, std) each
    ("isax", 65, 130, 65),          # a 65-symbol SAX word
])
def test_lower_bounds_match_reference_kernel(backbone, width, m, d):
    """``bounds.lower_bounds`` on the CPU (the reference's op order) and the
    port's pre-scaled box form (``box_lb.ops``, its plain version here)
    against the reference's Pallas box kernel in interpret mode, on the
    same index's summaries; relative 2.2e-5 is what pre-scaling moves a
    bound near a box edge (``core/bounds.py``)."""
    series = _series(3000, m)
    if backbone == "dstree":
        index = tree.build_dstree(series, 128, width)
        boxes = index.payload["eapca_box"]
        assert boxes.shape[1] * 2 == d
        q = torch.from_numpy(_series(24, m, seed=1))
        qstats = summaries.segment_stats(q, width)
        want = np.asarray(j_box_ops.eapca_lb(
            jnp.asarray(qstats.numpy()), jnp.asarray(boxes.numpy()),
            jnp.asarray(index.payload["seg_len"].numpy()), interpret=True))
        scaled = box_ops.eapca_lb(qstats, boxes, index.payload["seg_len"])
    else:
        index = tree.build_isax(series, 128, width)
        edges = index.payload["sax_edges"]
        assert edges.shape[1] == d
        q = torch.from_numpy(_series(24, m, seed=1))
        qpaa = summaries.paa(q, width)
        want = np.asarray(j_box_ops.sax_lb(
            jnp.asarray(qpaa.numpy()), jnp.asarray(edges.numpy()),
            length=m, interpret=True))
        scaled = box_ops.sax_lb(qpaa, edges, length=m)
    got = bounds.lower_bounds(index, q).numpy()
    assert got.shape == (24, index.n_leaves) and np.isfinite(got).all()
    assert (got > 0).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=2.5e-5, atol=1e-5)
    np.testing.assert_allclose(scaled.numpy(), want, rtol=2.5e-5, atol=1e-5)


def test_card_kernel_takes_any_d():
    """No tile, guard or message of the box kernel caps d: the wrapper
    refuses only d < 1 (before it builds anything), the C entry only
    d <= 0, and every d other than the two register instances takes the
    generic kernel."""
    with pytest.raises(ValueError, match="at least one"):
        box_kernel.box_lb_cuda(torch.zeros((2, 0)), torch.zeros((3, 0)),
                               torch.zeros((3, 0)))
    assert not hasattr(box_kernel, "_MAX_D")
    source = (common.CSRC / "box_lb.cu").read_text()
    assert "MAX_D" not in source and "d > 64" not in source
    assert re.search(r"if \(d <= 0\) return cudaErrorInvalidValue;", source)
    assert "return launch_any_d(q, lo, hi, out, Q, L, d, stream);" in source


def test_chip_smoke_holds_wide_boxes_and_builds_a_wide_dstree():
    """The card run holds the kernel at d = 65, 128 and 512 (both query
    paths among them) and builds a DSTree at 64 segments (d = 128) on
    100,000 series, whose exact search it holds to brute force."""
    smoke = _load_smoke()
    ds = {d for _, _, d in smoke.RAGGED_BOX}
    assert {65, 128, 512} <= ds
    assert {Q <= 4 for Q, _, d in smoke.RAGGED_BOX if d > 64} == {True,
                                                                  False}
    defaults = inspect.signature(smoke.run_wide_dstree).parameters
    assert defaults["n_segments"].default == 64
    assert defaults["n"].default == 100_000
    assert defaults["n_queries"].default == 64
    assert defaults["m"].default == 256


def test_wide_dstree_exact_search_equals_brute_force():
    """A DSTree at 64 segments (d = 128) built and searched on the CPU:
    exact search at k = 5 equals brute force."""
    series = _series(1500, 256)
    cfg = build.LeaFiConfig(backbone="dstree", n_segments=64,
                            leaf_capacity=128, t_filter_over_t_series=5.0,
                            n_global=40, n_local=16,
                            train=filter_training.TrainConfig(epochs=2))
    lfi = build.build_leafi(series, cfg, device="cpu")
    assert lfi.index.payload["eapca_box"].shape[1] == 64
    q = summaries.znormalize(torch.from_numpy(_series(16, 256, seed=2)))
    r = lfi.search_exact(q.numpy(), k=5, device="cpu")
    z = lfi.index.series[: lfi.index.n_series]
    d = torch.cdist(q.double(), z.double())
    want = lfi.index.order.numpy()[torch.argsort(d, dim=1)[:, :5].numpy()]
    assert (np.sort(r.ids, 1) == np.sort(want, 1)).all()
