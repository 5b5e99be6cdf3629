"""The port's kernel modules against the JAX package's, on the CPU.

The same numpy inputs go through the reference wrapper (its Pallas kernel
in interpret mode where it has one) and the port's wrapper (its plain
version, since the tensors lie on the CPU).  Tolerance rtol = atol = 1e-5:
f32 reductions run in another order in the two frameworks.  The quantized
filter cases take the reference's bf16/int8 payload on both sides, so they
differ only by that order too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds, filters, summaries, tree
from repro.kernels.box_lb import ops as box_ops
from repro.kernels.filter_mlp import ops as mlp_ops
from repro.kernels.l2_scan import ops as l2_ops
from repro_torch.core import bounds as t_bounds
from repro_torch.core import filters as t_filters
from repro_torch.kernels.box_lb import ops as t_box_ops
from repro_torch.kernels.filter_mlp import ops as t_mlp_ops
from repro_torch.kernels.filter_mlp import ref as t_mlp_ref
from repro_torch.kernels.l2_scan import ops as t_l2_ops
from _torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("Q,B,m", [(1, 1, 8), (3, 17, 96), (130, 64, 256),
                                   (5, 300, 33)])
def test_pairwise_l2_matches_reference(Q, B, m):
    rng = np.random.default_rng(Q * 1000 + B)
    q, s = _rand(rng, Q, m), _rand(rng, B, m)
    want = np.asarray(l2_ops.pairwise_l2(jnp.asarray(q), jnp.asarray(s),
                                         interpret=True))
    got = t_l2_ops.pairwise_l2(torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_masked_min_l2_matches_reference():
    rng = np.random.default_rng(5)
    q, slab = _rand(rng, 4, 64), _rand(rng, 50, 64)
    valid = np.arange(50) < 37
    wd, wi = l2_ops.masked_min_l2(jnp.asarray(q), jnp.asarray(slab),
                                  jnp.asarray(valid), interpret=True)
    gd, gi = t_l2_ops.masked_min_l2(torch.from_numpy(q),
                                    torch.from_numpy(slab),
                                    torch.from_numpy(valid))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **TOL)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("impl", ["direct", "matmul", "pairwise"])
@pytest.mark.parametrize("F,Nq,R,m", [(1, 1, 1, 8), (3, 5, 17, 96),
                                      (2, 9, 300, 33)])
def test_slab_l2_matches_reference(impl, F, Nq, R, m):
    rng = np.random.default_rng(F * 100 + R)
    q, s = _rand(rng, F, Nq, m), _rand(rng, F, R, m)
    kw = {"interpret": True} if impl == "pairwise" else {}
    want = np.asarray(l2_ops.slab_l2(jnp.asarray(q), jnp.asarray(s), impl,
                                     **kw))
    got = t_l2_ops.slab_l2(torch.from_numpy(q), torch.from_numpy(s), impl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("impl", ["direct", "matmul", "pairwise"])
@pytest.mark.parametrize("Q,C,R,m", [(1, 1, 1, 8), (7, 3, 17, 96),
                                     (4, 5, 40, 33)])
def test_shared_slab_l2_matches_reference(impl, Q, C, R, m):
    rng = np.random.default_rng(Q * 100 + C)
    q, s = _rand(rng, Q, m), _rand(rng, C, R, m)
    kw = {"interpret": True} if impl == "pairwise" else {}
    want = np.asarray(l2_ops.shared_slab_l2(jnp.asarray(q), jnp.asarray(s),
                                            impl, **kw))
    got = t_l2_ops.shared_slab_l2(torch.from_numpy(q), torch.from_numpy(s),
                                  impl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("impl", ["direct", "matmul"])
def test_gathered_leaf_l2_matches_reference(impl):
    rng = np.random.default_rng(11)
    q, s = _rand(rng, 6, 40), _rand(rng, 6, 3, 19, 40)
    want = np.asarray(l2_ops.gathered_leaf_l2(jnp.asarray(q), jnp.asarray(s),
                                              impl))
    got = t_l2_ops.gathered_leaf_l2(torch.from_numpy(q), torch.from_numpy(s),
                                    impl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_gather_leaf_slabs_and_masked_min_match_reference():
    rng = np.random.default_rng(2)
    series = _rand(rng, 80, 32)
    starts, sizes = np.array([0, 20, 45]), np.array([20, 25, 11])
    ids = np.array([0, 1, 2, 3])            # 3 == L: an invalid sentinel
    ws, wr, wv = l2_ops.gather_leaf_slabs(
        jnp.asarray(series), jnp.asarray(starts), jnp.asarray(sizes),
        jnp.asarray(ids), 30)
    gs, gr, gv = t_l2_ops.gather_leaf_slabs(
        torch.from_numpy(series), torch.from_numpy(starts),
        torch.from_numpy(sizes), torch.from_numpy(ids), 30)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    q = _rand(rng, 4, 7, 32)
    wd = l2_ops.slab_l2(jnp.asarray(q), ws, "direct")
    wmin, warg = l2_ops.slab_masked_min(wd, wv)
    gmin, garg = t_l2_ops.slab_masked_min(
        t_l2_ops.slab_l2(torch.from_numpy(q), gs, "direct"), gv)
    np.testing.assert_allclose(gmin.numpy(), np.asarray(wmin), **TOL)
    np.testing.assert_array_equal(garg.numpy(), np.asarray(warg))


def test_leaf_topk_breaks_ties_toward_the_lower_row():
    rng = np.random.default_rng(3)
    # few distinct values → many exact ties inside every leaf
    d = rng.integers(0, 4, (5, 3, 16)).astype(np.float32)
    d[0, 0, 5:] = np.inf
    rows = np.broadcast_to(np.arange(16) + 100, d.shape).copy()
    for k in (1, 4, 16):
        wv, wi = l2_ops.leaf_topk(jnp.asarray(d), jnp.asarray(rows), k)
        gv, gi = t_l2_ops.leaf_topk(torch.from_numpy(d),
                                    torch.from_numpy(rows), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_default_impls_follow_the_device():
    cpu = torch.device("cpu")
    assert t_l2_ops.default_gathered_impl(cpu) == "direct"
    assert t_l2_ops.default_slab_impl(cpu) == "matmul"
    assert t_l2_ops.default_gathered_impl(torch.device("cuda")) == "matmul"
    assert t_l2_ops.default_slab_impl(torch.device("cuda")) == "pairwise"
    q = torch.zeros(2, 3)
    np.testing.assert_array_equal(
        t_l2_ops.reference(q, q).numpy(),
        np.asarray(l2_ops.reference(jnp.zeros((2, 3)), jnp.zeros((2, 3)))))


@pytest.mark.parametrize("with_offsets", [False, True])
@pytest.mark.parametrize("F,Q,m,h", [(1, 1, 8, 8), (5, 7, 96, 96),
                                     (13, 140, 64, 128), (3, 32, 256, 17)])
def test_filter_predict_fused_matches_reference(F, Q, m, h, with_offsets):
    rng = np.random.default_rng(F * 10 + Q)
    w1, b1 = _rand(rng, F, m, h, scale=0.1), _rand(rng, F, h, scale=0.1)
    w2, b2 = _rand(rng, F, h, scale=0.1), _rand(rng, F)
    ym, ys = _rand(rng, F), np.abs(_rand(rng, F)) + 0.5
    q = _rand(rng, Q, m)
    off = np.abs(_rand(rng, F)) if with_offsets else None
    j = [jnp.asarray(a) for a in (w1, b1, w2, b2, ym, ys, q)]
    want = np.asarray(mlp_ops.filter_predict_fused(
        *j, None if off is None else jnp.asarray(off), interpret=True))
    t = [torch.from_numpy(a) for a in (w1, b1, w2, b2, ym, ys, q)]
    got = t_mlp_ops.filter_predict_fused(
        *t, None if off is None else torch.from_numpy(off))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the plain composition the wrapper runs on the CPU is the oracle itself
    np.testing.assert_array_equal(
        got.numpy(), t_mlp_ops.fused_reference(
            *t, None if off is None else torch.from_numpy(off)).numpy())
    np.testing.assert_allclose(
        t_mlp_ops.reference(*t[:4], t[6]).numpy(),
        np.asarray(mlp_ops.reference(*j[:4], j[6])), **TOL)


def _from_jax(a) -> torch.Tensor:
    """A JAX array as a tensor of the same dtype (bfloat16 bit for bit)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("weight_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("F,Q,m,h", [(1, 1, 8, 8), (5, 7, 96, 96),
                                     (13, 140, 64, 128), (3, 32, 256, 17)])
def test_filter_predict_fused_quantized_matches_reference(F, Q, m, h,
                                                          weight_dtype):
    """The reference quantizes; both sides take its bf16/int8 payload."""
    rng = np.random.default_rng(F * 10 + Q + 1)
    w1, b1 = _rand(rng, F, m, h, scale=0.1), _rand(rng, F, h, scale=0.1)
    w2, b2 = _rand(rng, F, h, scale=0.1), _rand(rng, F)
    ym, ys = _rand(rng, F), np.abs(_rand(rng, F)) + 0.5
    q, off = _rand(rng, Q, m), np.abs(_rand(rng, F))
    p = filters.quantize_mlp({"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)},
                             weight_dtype)
    s1, s2 = p.get("w1_scale"), p.get("w2_scale")
    j = [jnp.asarray(a) for a in (b1, b2, ym, ys, q, off)]
    want = np.asarray(mlp_ops.filter_predict_fused(
        p["w1"], j[0], p["w2"], *j[1:], s1, s2, interpret=True))
    t = [torch.from_numpy(a) for a in (b1, b2, ym, ys, q, off)]
    ts = [None if x is None else _from_jax(x) for x in (s1, s2)]
    got = t_mlp_ops.filter_predict_fused(
        _from_jax(p["w1"]), t[0], _from_jax(p["w2"]), *t[1:], *ts)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("Q,L,d", [(1, 1, 4), (9, 200, 16), (150, 37, 8),
                                   (70, 130, 64), (7, 1003, 5),
                                   (1, 4093, 16)])
def test_box_lb_matches_reference(Q, L, d):
    rng = np.random.default_rng(Q + L + d)
    q = _rand(rng, Q, d)
    centers, width = _rand(rng, L, d), np.abs(_rand(rng, L, d))
    lo, hi = centers - width, centers + width
    lo[0], hi[-1] = -np.inf, np.inf        # open sides, as SAX extremes
    want = np.asarray(box_ops.box_lb(jnp.asarray(q), jnp.asarray(lo),
                                     jnp.asarray(hi), interpret=True))
    got = t_box_ops.box_lb(*(torch.from_numpy(a) for a in (q, lo, hi)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert t_box_ops.reference(*(torch.from_numpy(a) for a in (q, lo, hi))
                               ).shape == (Q, L)


@pytest.fixture(scope="module")
def both_backbones(randwalk_small):
    S = randwalk_small[:1500]
    q = summaries.znormalize(S[:9] + 0.5)
    return (S, q, tree.build_isax(S, leaf_capacity=64),
            tree.build_dstree(S, leaf_capacity=64))


def test_sax_lb_matches_reference(both_backbones):
    S, q, idx_i, _ = both_backbones
    edges = np.array(idx_i.payload["sax_edges"])
    qp = np.array(summaries.paa(jnp.asarray(q), edges.shape[1]))
    want = np.asarray(box_ops.sax_lb(jnp.asarray(qp), jnp.asarray(edges),
                                     length=S.shape[1], interpret=True))
    tq, te = torch.from_numpy(qp), torch.from_numpy(edges)
    got = t_box_ops.sax_lb(tq, te, length=S.shape[1])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the pre-scaled form against the plain bound: 1e-5 relative
    np.testing.assert_allclose(
        got.numpy(), t_bounds.sax_lower_bound(tq, te, S.shape[1]).numpy(),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(bounds.sax_lower_bound(
            jnp.asarray(qp), jnp.asarray(edges), S.shape[1])),
        rtol=1e-5, atol=1e-6)


def test_eapca_lb_matches_reference(both_backbones):
    _, q, _, idx_d = both_backbones
    boxes = np.array(idx_d.payload["eapca_box"])
    seg = np.array(idx_d.payload["seg_len"])
    qs = np.array(summaries.segment_stats(jnp.asarray(q), boxes.shape[1]))
    want = np.asarray(box_ops.eapca_lb(jnp.asarray(qs), jnp.asarray(boxes),
                                       jnp.asarray(seg), interpret=True))
    t = [torch.from_numpy(a) for a in (qs, boxes, seg)]
    got = t_box_ops.eapca_lb(*t)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), t_bounds.eapca_lower_bound(t[0], t[1],
                                                t[2].float()).numpy(),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(bounds.eapca_lower_bound(
            jnp.asarray(qs), jnp.asarray(boxes), jnp.asarray(seg))),
        rtol=1e-5, atol=1e-6)


def test_quantized_payload_reaches_the_plain_version_dequantized():
    """On the CPU the wrapper runs the plain composition on dequantized
    weights: bitwise the oracle on ``dequantize_weights``' output."""
    rng = np.random.default_rng(4)
    p = {"w1": torch.from_numpy(_rand(rng, 4, 16, 8)),
         "w2": torch.from_numpy(_rand(rng, 4, 8))}
    q = torch.from_numpy(_rand(rng, 5, 16))
    b1, b2 = torch.zeros(4, 8), torch.zeros(4)
    ym, ys = torch.zeros(4), torch.ones(4)
    for dtype in ("bfloat16", "int8"):
        pq = t_filters.quantize_mlp(p, dtype)
        s1, s2 = pq.get("w1_scale"), pq.get("w2_scale")
        w1f, w2f = t_mlp_ref.dequantize_weights(pq["w1"], pq["w2"], s1, s2)
        np.testing.assert_array_equal(
            t_mlp_ops.filter_predict_fused(pq["w1"], b1, pq["w2"], b2, ym,
                                           ys, q, None, s1, s2).numpy(),
            t_mlp_ops.fused_reference(w1f, b1, w2f, b2, ym, ys, q).numpy())
