"""The port's kernel modules against the JAX package's, on the CPU.

The same numpy inputs go through the reference wrapper (its Pallas kernel
in interpret mode where it has one) and the port's wrapper (its plain
version, since the tensors lie on the CPU).  Tolerance rtol = atol = 1e-5:
f32 reductions run in another order in the two frameworks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.filter_mlp import ops as mlp_ops
from repro.kernels.l2_scan import ops as l2_ops
from repro_torch.kernels.filter_mlp import ops as t_mlp_ops
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
