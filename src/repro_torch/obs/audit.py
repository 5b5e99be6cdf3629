"""Per-leaf filter health: the ``FilterAudit`` accumulators (port of
``repro.obs.audit``).

``CascadeTrace`` answers which bound saved which compute per query;
``FilterAudit`` answers it per leaf, and adds how tight each filter's
adjusted prediction ran on the leaves the engine scored exactly, at no
extra distance computation.

Two stages: the engine emits per-(query, leaf) decision planes
(:class:`AuditParts`, every plane (Q, L)) at the stage where its prune
decision happened, the same stage ``CascadeTrace`` attributes at; then
:func:`reduce_parts` folds them over the queries into the per-leaf
accumulators.

For a leaf the engine scored exactly, with a filter (``d_F`` finite), the
residual is ``true_leaf_nn − d_F``.  A negative residual means the
adjusted prediction over-estimated the leaf's nearest-neighbour distance:
had the bsf lain between the two, the filter would have pruned a leaf
holding a closer neighbour.  ``violations`` counts those, ``resid_min``
keeps the worst, and ``resid_buckets`` histograms the residuals against
the fixed :data:`RESIDUAL_EDGES`.

The per-leaf accounting identity, for every engine path::

    pruned_box + pruned_seed + pruned_filter + kept == n_queries
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_INF = float("inf")

#: Fixed residual-histogram bucket edges (z-normalized distance units).
#: Buckets are ``(-inf, e0], (e0, e1], …, (e_last, inf)``: the two below 0
#: count the unsafe residuals by severity, the ones above measure how much
#: pruning the conformal offset gave away.  Fixed, so histograms of
#: different batches add without re-binning.
RESIDUAL_EDGES = (-1.0, -0.1, 0.0, 0.1, 1.0, 10.0)
N_BUCKETS = len(RESIDUAL_EDGES) + 1


class AuditParts(NamedTuple):
    """Per-(query, leaf) decision planes, every one (Q, L).

    ``p_box`` / ``p_seed`` / ``p_filter`` (bool): the leaves excluded from
    the distance pass, by the first bound that excluded them.  ``kept``
    (bool): the rest, whose rows entered the distance pass (on the compact
    strategy the probe leaf too).  ``scored`` (bool): leaves with an exact
    nearest-neighbour distance in ``leaf_nn`` — ``kept`` on the scan
    strategy, a superset under the compact strategy's pairwise union.
    ``leaf_nn`` (float32): that distance where ``scored``, +inf elsewhere.
    """

    p_box: torch.Tensor
    p_seed: torch.Tensor
    p_filter: torch.Tensor
    kept: torch.Tensor
    scored: torch.Tensor
    leaf_nn: torch.Tensor


class FilterAudit(NamedTuple):
    """Per-leaf accumulators; every field (L,) but ``resid_buckets`` (L,
    N_BUCKETS).  They add across batches (:func:`combine`), except
    ``resid_min``, which combines by minimum."""

    pruned_box: torch.Tensor      # int32: queries this leaf was box-pruned for
    pruned_seed: torch.Tensor     # int32: … excluded only by the bsf_ub bound
    pruned_filter: torch.Tensor   # int32: … excluded by the learned filter
    kept: torch.Tensor            # int32: queries whose distance pass paid it
    scored: torch.Tensor          # int32: queries with an exact leaf-NN here
    rows_saved: torch.Tensor      # int32: pruned-away distance rows (× size)
    resid_count: torch.Tensor     # int32: residual observations
    resid_sum: torch.Tensor       # float32: Σ residual
    resid_sumsq: torch.Tensor     # float32: Σ residual²
    resid_min: torch.Tensor       # float32: the most negative residual; +inf
    violations: torch.Tensor      # int32: residual < 0 observations
    resid_buckets: torch.Tensor   # int32 (L, N_BUCKETS) fixed-edge histogram


def zero_parts(n_queries: int, n_leaves: int, device=None) -> AuditParts:
    """All-false planes and +inf distances."""
    f = torch.zeros((n_queries, n_leaves), dtype=torch.bool, device=device)
    return AuditParts(f, f, f, f, f, torch.full((n_queries, n_leaves), _INF,
                                                device=device))


def zero_audit(n_leaves: int, device=None) -> FilterAudit:
    """The identity of :func:`combine` for ``n_leaves`` leaves."""
    zi = torch.zeros((n_leaves,), dtype=torch.int32, device=device)
    zf = torch.zeros((n_leaves,), device=device)
    return FilterAudit(zi, zi, zi, zi, zi, zi, zi, zf, zf,
                       torch.full((n_leaves,), _INF, device=device), zi,
                       torch.zeros((n_leaves, N_BUCKETS), dtype=torch.int32,
                                   device=device))


def select_parts(cond, a: AuditParts, b: AuditParts) -> AuditParts:
    """Per-query ``where(cond, a, b)`` across every plane."""
    c = torch.as_tensor(cond, device=a.p_box.device)[:, None]
    return AuditParts(*(torch.where(c, x, y) for x, y in zip(a, b)))


def _count(plane: torch.Tensor) -> torch.Tensor:
    return plane.sum(dim=0, dtype=torch.int32)


def reduce_parts(parts: AuditParts, d_F: torch.Tensor,
                 leaf_size: torch.Tensor) -> FilterAudit:
    """Fold the (Q, L) decision planes into the per-leaf accumulators.

    ``d_F``: the (Q, L) adjusted predictions the engine pruned with (−inf:
    the leaf has no filter, and gives no residual).  ``leaf_size``: (L,)
    rows a leaf, for the rows saved.  A residual on an edge lands in the
    bucket the edge closes (``searchsorted``'s left side).
    """
    pruned = parts.p_box | parts.p_seed | parts.p_filter
    rmask = (parts.scored & torch.isfinite(d_F)
             & torch.isfinite(parts.leaf_nn))
    resid = torch.where(rmask, parts.leaf_nn - d_F, 0.0)
    edges = torch.tensor(RESIDUAL_EDGES, dtype=torch.float32,
                         device=d_F.device)
    bidx = torch.searchsorted(
        edges, torch.where(rmask, resid, _INF).contiguous(),
        right=False)                                        # (Q, L)
    buckets = rmask[:, :, None] & (
        bidx[:, :, None] == torch.arange(N_BUCKETS, device=d_F.device))
    return FilterAudit(
        pruned_box=_count(parts.p_box),
        pruned_seed=_count(parts.p_seed),
        pruned_filter=_count(parts.p_filter),
        kept=_count(parts.kept),
        scored=_count(parts.scored),
        rows_saved=_count(pruned) * leaf_size.to(torch.int32),
        resid_count=_count(rmask),
        resid_sum=resid.sum(dim=0),
        resid_sumsq=(resid * resid).sum(dim=0),
        resid_min=torch.where(rmask, resid, _INF).amin(dim=0),
        violations=_count(rmask & (resid < 0.0)),
        resid_buckets=buckets.sum(dim=0, dtype=torch.int32))


def combine(a: FilterAudit, b: FilterAudit) -> FilterAudit:
    """Leaf-wise merge: sums everywhere, the minimum for ``resid_min``."""
    return FilterAudit(*(torch.minimum(x, y) if name == "resid_min"
                         else x + y
                         for name, x, y in zip(FilterAudit._fields, a, b)))


def scatter_global(audit: FilterAudit, leaf_global: torch.Tensor,
                   n_leaves: int) -> FilterAudit:
    """Fold shard-local audits into global leaf order.

    ``audit``: fields (S, P) ((S, P, N_BUCKETS) for the buckets), one row
    per shard; ``leaf_global``: (S, P) each slot's global leaf id, padding
    slots ``n_leaves``, which land in a scratch row that is cut off.
    """
    idx = torch.as_tensor(leaf_global).reshape(-1).to(torch.int64)

    def fold(x: torch.Tensor, name: str) -> torch.Tensor:
        flat = x.reshape((idx.shape[0],) + tuple(x.shape[2:]))
        shape = (n_leaves + 1,) + tuple(flat.shape[1:])
        if name == "resid_min":
            out = torch.full(shape, _INF, dtype=flat.dtype, device=flat.device)
            at = idx.view((-1,) + (1,) * (flat.dim() - 1)).expand_as(flat)
            return out.scatter_reduce_(0, at, flat, "amin")[:n_leaves]
        out = torch.zeros(shape, dtype=flat.dtype, device=flat.device)
        return out.index_add_(0, idx, flat)[:n_leaves]

    return FilterAudit(*(fold(x, name)
                         for name, x in zip(FilterAudit._fields, audit)))


def to_numpy(audit: FilterAudit) -> dict:
    """Host-side dict (field name → numpy array, counters widened to
    int64)."""
    out = {}
    for name, val in zip(audit._fields, audit):
        arr = np.asarray(torch.as_tensor(val).cpu())
        out[name] = arr.astype(np.int64) if arr.dtype == np.int32 else arr
    return out


def accounting_residual_leaf(audit: FilterAudit,
                             n_queries: int) -> torch.Tensor:
    """``n_queries − kept − Σ pruned_*`` per leaf: zero everywhere when the
    per-leaf attribution partitions the queries exactly."""
    pruned = audit.pruned_box + audit.pruned_seed + audit.pruned_filter
    return (n_queries - audit.kept - pruned).to(torch.int32)
