"""The port's cascade trace and filter audit helpers (``repro_torch.obs``)
against the JAX package's (``repro.obs.trace``, ``repro.obs.audit``), on
the same numpy inputs made from a seed.

Counters are compared exactly.  The residuals are drawn from a grid of
multiples of 1/8, so every residual and every sum of them is exact in
float32 in any order; the float fields are still compared within rtol
1e-6.  The inputs hold residuals exactly on each of ``RESIDUAL_EDGES``
(the float32 value of the edge), -inf predictions (no filter), +inf leaf
distances (never scored), and ``scatter_global``'s padding slots.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import audit as j_audit
from repro.obs import trace as j_trace
from repro_torch import obs
from repro_torch.obs import audit as t_audit
from repro_torch.obs import trace as t_trace
from _torch_threads import one_torch_thread  # noqa: F401

EDGES32 = np.asarray(j_audit.RESIDUAL_EDGES, np.float32)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_fields(got, want, rtol=1e-6):
    """Field by field: integer fields exactly, float fields within rtol
    (infinities in the same places)."""
    assert got._fields == want._fields
    for name, g, w in zip(want._fields, got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == np.float32, name
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=name)
        else:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _trace_arrays(seed: int, Q: int = 9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 50, Q).astype(np.int32)
            for _ in j_trace.CascadeTrace._fields]


def test_trace_helpers_match_reference():
    a, b = _trace_arrays(0), _trace_arrays(1)
    ja = j_trace.CascadeTrace(*(jnp.asarray(x) for x in a))
    jb = j_trace.CascadeTrace(*(jnp.asarray(x) for x in b))
    ta = t_trace.CascadeTrace(*(torch.from_numpy(x) for x in a))
    tb = t_trace.CascadeTrace(*(torch.from_numpy(x) for x in b))
    assert t_trace.CascadeTrace._fields == j_trace.CascadeTrace._fields
    _assert_fields(t_trace.zero_trace(9), j_trace.zero_trace(9))
    _assert_fields(t_trace.combine(ta, tb), j_trace.combine(ja, jb))
    cond = np.random.default_rng(2).random(9) < 0.5
    _assert_fields(t_trace.select(cond, ta, tb),
                   j_trace.select(jnp.asarray(cond), ja, jb))
    _assert_fields(t_trace.select(torch.from_numpy(cond), ta, tb),
                   j_trace.select(cond, ja, jb))
    got, want = t_trace.to_numpy(ta), j_trace.to_numpy(ja)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype == np.int64
        np.testing.assert_array_equal(got[name], want[name])
    n_leaves = 120
    res = t_trace.accounting_residual(ta, n_leaves)
    assert res.dtype == torch.int32
    np.testing.assert_array_equal(
        res.numpy(), np.asarray(j_trace.accounting_residual(ja, n_leaves)))


def test_obs_package_exports():
    assert obs.CascadeTrace is t_trace.CascadeTrace
    assert obs.FilterAudit is t_audit.FilterAudit
    assert obs.RESIDUAL_EDGES == j_audit.RESIDUAL_EDGES
    assert t_audit.N_BUCKETS == j_audit.N_BUCKETS
    assert t_audit.FilterAudit._fields == j_audit.FilterAudit._fields
    assert t_audit.AuditParts._fields == j_audit.AuditParts._fields
    for name in ("zero_trace", "combine", "select", "to_numpy",
                 "accounting_residual", "AuditParts",
                 "accounting_residual_leaf", "audit", "trace"):
        assert hasattr(obs, name), name


def _parts(seed: int, Q: int = 16, L: int = 23):
    """numpy AuditParts planes, predictions and leaf sizes: a partition of
    each (query, leaf) into box, seed, filter or kept; scored a superset
    of kept; leaf distances and predictions on a 1/8 grid, with residuals
    exactly on every edge, -inf predictions and +inf distances."""
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 4, (Q, L))
    p_box, p_seed, p_filter, kept = (cls == c for c in range(4))
    scored = kept | (rng.random((Q, L)) < 0.2)
    d_F = (rng.integers(-16, 120, (Q, L)) / 8.0).astype(np.float32)
    leaf_nn = (d_F + rng.integers(-40, 100, (Q, L)) / 8.0).astype(np.float32)
    d_F[rng.random((Q, L)) < 0.1] = -np.inf
    kept[:, -1] = scored[:, -1] = False        # a leaf never scored
    p_box[:, -1] = True
    p_seed[:, -1] = p_filter[:, -1] = False
    leaf_nn[~scored] = np.inf
    leaf_nn[rng.random((Q, L)) < 0.05] = np.inf
    # residuals exactly on each edge: d_F = 0, leaf_nn = the edge
    for j, e in enumerate(EDGES32):
        d_F[j % Q, j] = 0.0
        leaf_nn[j % Q, j] = e
        scored[j % Q, j] = True
    sizes = rng.integers(0, 200, L).astype(np.int64)
    return (p_box, p_seed, p_filter, kept, scored, leaf_nn), d_F, sizes


def _both_parts(planes):
    return (j_audit.AuditParts(*(jnp.asarray(p) for p in planes)),
            t_audit.AuditParts(*(torch.from_numpy(np.ascontiguousarray(p))
                                 for p in planes)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reduce_parts_matches_reference(seed):
    planes, d_F, sizes = _parts(seed)
    jp, tp = _both_parts(planes)
    want = j_audit.reduce_parts(jp, jnp.asarray(d_F),
                                jnp.asarray(sizes.astype(np.int32)))
    got = t_audit.reduce_parts(tp, torch.from_numpy(d_F),
                               torch.from_numpy(sizes))
    _assert_fields(got, want)
    # every edge's residual is observed, in the bucket the edge closes
    buckets = got.resid_buckets.numpy()
    for j in range(len(EDGES32)):
        assert buckets[j, j] >= 1
    np.testing.assert_array_equal(buckets.sum(-1), got.resid_count.numpy())
    assert int(got.resid_count.sum()) > 0
    assert np.isinf(got.resid_min.numpy()).any()
    assert not t_audit.accounting_residual_leaf(got, 16).any()
    np.testing.assert_array_equal(
        t_audit.accounting_residual_leaf(got, 16).numpy(),
        np.asarray(j_audit.accounting_residual_leaf(want, 16)))


def test_zero_parts_audit_and_select_match_reference():
    _assert_fields(t_audit.zero_parts(4, 7), j_audit.zero_parts(4, 7))
    _assert_fields(t_audit.zero_audit(7), j_audit.zero_audit(7))
    planes, _, _ = _parts(3, 4, 7)
    jp, tp = _both_parts(planes)
    cond = np.asarray([True, False, False, True])
    _assert_fields(t_audit.select_parts(cond, tp, t_audit.zero_parts(4, 7)),
                   j_audit.select_parts(cond, jp, j_audit.zero_parts(4, 7)))


def _both_audits(seed: int):
    planes, d_F, sizes = _parts(seed)
    jp, tp = _both_parts(planes)
    return (j_audit.reduce_parts(jp, jnp.asarray(d_F),
                                 jnp.asarray(sizes.astype(np.int32))),
            t_audit.reduce_parts(tp, torch.from_numpy(d_F),
                                 torch.from_numpy(sizes)))


def test_combine_sums_and_takes_the_minimum():
    ja, ta = _both_audits(4)
    jb, tb = _both_audits(5)
    got = t_audit.combine(ta, tb)
    _assert_fields(got, j_audit.combine(ja, jb))
    np.testing.assert_array_equal(
        got.resid_min.numpy(),
        np.minimum(ta.resid_min.numpy(), tb.resid_min.numpy()))
    np.testing.assert_array_equal(
        got.kept.numpy(), ta.kept.numpy() + tb.kept.numpy())
    _assert_fields(t_audit.combine(ta, t_audit.zero_audit(23)), ta)


def test_scatter_global_matches_reference():
    """Three shards of 23 slots into 40 global leaves: ids shared between
    shards add (and take the minimum), padding slots (id 40) vanish."""
    rng = np.random.default_rng(6)
    j_rows, t_rows = zip(*(_both_audits(s) for s in (7, 8, 9)))
    j_stack = j_audit.FilterAudit(*(jnp.stack(f) for f in zip(*j_rows)))
    t_stack = t_audit.FilterAudit(*(torch.stack(f) for f in zip(*t_rows)))
    leaf_global = rng.integers(0, 40, (3, 23))
    leaf_global[rng.random((3, 23)) < 0.2] = 40          # padding slots
    want = j_audit.scatter_global(j_stack, jnp.asarray(leaf_global), 40)
    got = t_audit.scatter_global(t_stack, torch.from_numpy(leaf_global), 40)
    _assert_fields(got, want)
    assert got.kept.shape == (40,) and got.resid_buckets.shape == (40, 7)
    kept = t_stack.kept.numpy()
    live = leaf_global < 40
    assert int(got.kept.sum()) == int(kept[live].sum())
    assert np.isinf(got.resid_min.numpy()).any()     # leaves no slot names


def test_audit_to_numpy_matches_reference():
    ja, ta = _both_audits(10)
    got, want = t_audit.to_numpy(ta), j_audit.to_numpy(ja)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   err_msg=name)
