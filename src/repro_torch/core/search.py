"""LeaFi-enhanced search, paper Alg. 2 (port of ``repro.core.search``).

Three forms over the same semantics:

* ``search_batched`` — throughput form.  Lower bounds and filter
  predictions for all leaves are computed up front (neither depends on the
  best-so-far), then the pruning cascade runs through
  :mod:`repro_torch.core.engine`.
* ``search_batched_grouped`` — a batch with per-query quality targets
  answered as one homogeneous sub-batch per target.
* ``search_early`` — latency form for one query: leaves are visited in
  lower-bound order, a leaf whose filter prediction exceeds the
  best-so-far is skipped without a scan, and the first lower bound above
  the best-so-far ends the search (every later leaf is prunable too).  As
  the reference runs the walk as one device program, the card runs it as
  one launch of the early-walk kernel (``kernels/early_walk``), after the
  bounds, the predictions and a device argsort; the result comes to the
  host in one copy at the end.

``quality_target=None`` (or ``use_filters=False``) disables the filters and
the search is exact.  The batched forms take the engine's prune-only bound
``bsf_ub`` and its ``trace`` and ``audit`` flags; the result then carries
the trace and the audit as numpy dicts with the reference's field names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from . import bounds as bounds_mod
from . import conformal, engine, filters
from .flat_index import FlatIndex
from ..kernels import common
from ..kernels.common import Device, resolve_device
from ..kernels.early_walk import kernel as walk_kernel
from ..kernels.early_walk import ref as walk_ref
from ..obs.audit import FilterAudit
from ..obs.trace import CascadeTrace

_INF = float("inf")


@dataclasses.dataclass
class SearchResult:
    dists: np.ndarray            # (Q, k)
    ids: np.ndarray              # (Q, k) original series ids
    searched: np.ndarray         # (Q,) leaves actually scanned
    pruned_lb: np.ndarray        # (Q,) leaves pruned by summarization LB
    pruned_filter: np.ndarray    # (Q,) leaves pruned by learned filters
    n_leaves: int
    # leaves the engine paid distance compute for (== n_leaves on the scan
    # strategy; the survivor superset, or the bucket's survivor union under
    # dist_impl="pairwise", on the compact strategy)
    computed: Optional[np.ndarray] = None
    # search_batched(trace=True): the engine's per-query CascadeTrace as a
    # dict of int64 (Q,) arrays by field name, else None
    trace: Optional[dict] = None
    # search_batched(audit=True): the engine's per-leaf FilterAudit as a
    # dict by field name (counters int64, sums and minimum float32)
    audit: Optional[dict] = None

    @property
    def pruning_ratio(self) -> np.ndarray:
        return 1.0 - self.searched / self.n_leaves


@dataclasses.dataclass
class PendingSearch:
    """A dispatched batched search whose device work may still be running.

    ``done`` is a CUDA event recorded after the engine's last launch (None
    on the CPU); :meth:`result` waits on it and copies to the host.  The
    trace and the audit, where asked for, come over in one copy each.
    """
    raw: engine.EngineResult
    order: np.ndarray
    n_series: int
    n_leaves: int
    done: Optional[torch.cuda.Event] = None

    def synchronize(self) -> "PendingSearch":
        if self.done is not None:
            self.done.synchronize()
        return self

    def result(self) -> SearchResult:
        """Materialize to a :class:`SearchResult` (waits for the device)."""
        self.synchronize()
        r = self.raw
        ids_sorted = r.topk_i.cpu().numpy()
        orig = np.where(ids_sorted >= 0, self.order[
            np.clip(ids_sorted, 0, self.n_series - 1)], -1)
        return SearchResult(
            dists=r.topk_d.cpu().numpy(), ids=orig,
            searched=r.n_searched.cpu().numpy(),
            pruned_lb=r.n_pruned_lb.cpu().numpy(),
            pruned_filter=r.n_pruned_filter.cpu().numpy(),
            n_leaves=self.n_leaves, computed=r.n_computed.cpu().numpy(),
            trace=None if r.trace is None else _trace_to_host(r.trace),
            audit=None if r.audit is None else _audit_to_host(r.audit))


def _trace_to_host(trace: CascadeTrace) -> dict:
    """The trace's seven (Q,) fields, stacked and copied in one copy."""
    host = torch.stack(tuple(trace)).cpu().numpy().astype(np.int64)
    return dict(zip(CascadeTrace._fields, host))


#: the audit's float32 fields, carried through the one copy as their bits
_AUDIT_FLOATS = ("resid_sum", "resid_sumsq", "resid_min")


def _audit_to_host(audit: FilterAudit) -> dict:
    """The audit's fields packed into one int32 tensor (the float32 ones
    by their bits), copied in one copy and unpacked by field."""
    parts = [(val.view(torch.int32) if name in _AUDIT_FLOATS
              else val.to(torch.int32)).reshape(-1)
             for name, val in zip(FilterAudit._fields, audit)]
    host = torch.cat(parts).cpu().numpy()
    out, at = {}, 0
    for name, val in zip(FilterAudit._fields, audit):
        piece = host[at:at + val.numel()].reshape(tuple(val.shape))
        at += val.numel()
        out[name] = (piece.view(np.float32) if name in _AUDIT_FLOATS
                     else piece.astype(np.int64))
    return out


def predictions_for_all_leaves(index: FlatIndex,
                               filter_params: Optional[Dict[str,
                                                            torch.Tensor]],
                               leaf_ids: np.ndarray, queries: torch.Tensor,
                               offsets: Optional[np.ndarray],
                               filter_type: str = "mlp") -> torch.Tensor:
    """(Q, L) conformal-adjusted filter lower bounds; −inf ⇒ never prunes.

    ``filter_type`` selects the backbone through :data:`filters.APPLY`.
    ``offsets`` is one (F,) vector shared by the batch or (Q, F) per-query
    rows.  The MLP takes shared offsets into the fused kernel's epilogue;
    per-query rows, and any offsets of a CNN or LSTM, are subtracted from
    the backbone's unadjusted output.
    """
    L = index.n_leaves
    Q = queries.shape[0]
    dev = queries.device
    if filter_params is None or len(leaf_ids) == 0:
        return torch.full((Q, L), -_INF, device=dev)
    off = (None if offsets is None
           else torch.as_tensor(np.asarray(offsets, np.float32), device=dev))
    if filter_type == "mlp" and (off is None or off.dim() == 1):
        preds = filters.apply_mlp_offset(filter_params, queries, off)  # (F, Q)
    else:
        preds = filters.APPLY[filter_type](filter_params, queries)   # (F, Q)
        if off is not None:
            preds = preds - (off.T if off.dim() == 2 else off[:, None])
    full = torch.full((L, Q), -_INF, device=dev)
    full[torch.as_tensor(np.asarray(leaf_ids), device=dev)] = preds
    return full.T


def _bounds_and_predictions(index: FlatIndex, q: torch.Tensor,
                            filter_params, leaf_ids, tuner, quality_target,
                            use_filters: bool, dev: torch.device,
                            filter_type: str):
    """(Q, L) lower bounds and conformal-adjusted filter predictions of the
    queries ``q`` on ``dev`` (−inf predictions when the filters are off)."""
    if index.device != dev:
        raise ValueError(f"the index lives on {index.device}, the search "
                         f"was asked to run on {dev}")
    d_lb = bounds_mod.lower_bounds(index, q)                       # (Q, L)
    if not (use_filters and filter_params is not None):
        return d_lb, torch.full(d_lb.shape, -_INF, device=dev)
    offsets = None
    if tuner is not None and quality_target is not None:
        offsets = tuner.offsets(quality_target)        # (F,) or (Q, F)
    return d_lb, predictions_for_all_leaves(index, filter_params, leaf_ids,
                                            q, offsets, filter_type)


def search_batched_async(index: FlatIndex, queries, *, k: int = 1,
                         filter_params=None,
                         leaf_ids: Optional[np.ndarray] = None,
                         tuner: Optional[conformal.AutoTuner] = None,
                         quality_target=None, use_filters: bool = True,
                         filter_type: str = "mlp", strategy: str = "auto",
                         dist_impl: Optional[str] = None,
                         bsf_ub: Optional[np.ndarray] = None,
                         trace: bool = False, audit: bool = False,
                         device: Device = None) -> PendingSearch:
    """Dispatch a batched LeaFi search; same arguments as
    :func:`search_batched`.  The compact strategy syncs the host once for
    its survivor buckets; the rest is enqueued and ``.result()`` waits."""
    dev = resolve_device(device)
    q = torch.atleast_2d(torch.as_tensor(np.asarray(queries, np.float32),
                                         device=dev))
    if quality_target is not None:
        nd = np.ndim(quality_target)
        if nd > 1:
            raise ValueError(
                "quality_target must be a scalar or a (Q,) per-query "
                f"array, got shape {np.shape(quality_target)}")
        if nd == 1 and np.shape(quality_target)[0] != q.shape[0]:
            raise ValueError(
                f"per-query quality_target has {np.shape(quality_target)[0]} "
                f"entries for {q.shape[0]} queries")
    d_lb, d_F = _bounds_and_predictions(index, q, filter_params, leaf_ids,
                                        tuner, quality_target, use_filters,
                                        dev, filter_type)
    res = engine.run_cascade(
        index.series, index.leaf_start, index.leaf_size, q, d_lb, d_F,
        k=k, max_leaf=index.max_leaf_size, strategy=strategy,
        dist_impl=dist_impl, bsf_ub=bsf_ub, trace=trace, audit=audit)
    done = None
    if dev.type == "cuda":
        done = torch.cuda.Event()
        done.record()
    return PendingSearch(raw=res, order=index.order.cpu().numpy(),
                         n_series=index.n_series, n_leaves=index.n_leaves,
                         done=done)


def search_batched(index: FlatIndex, queries, *, k: int = 1,
                   filter_params=None, leaf_ids: Optional[np.ndarray] = None,
                   tuner: Optional[conformal.AutoTuner] = None,
                   quality_target=None, use_filters: bool = True,
                   filter_type: str = "mlp", strategy: str = "auto",
                   dist_impl: Optional[str] = None,
                   bsf_ub: Optional[np.ndarray] = None, trace: bool = False,
                   audit: bool = False,
                   device: Device = None) -> SearchResult:
    """Batched LeaFi search; exact when filters are disabled.

    ``quality_target`` is one target for the batch or an array of Q
    per-query targets (lowered to (Q, F) offset rows).  ``filter_type``
    ("mlp", "cnn" or "rnn") names the backbone of ``filter_params``.
    ``strategy`` is
    "compact" (the "auto" default) or "scan"; ``dist_impl`` selects the
    candidate pass (see :func:`engine.run_cascade`).  ``bsf_ub`` is an
    optional (Q,) prune-only upper bound on each query's true k-th nearest
    distance: it prunes more leaves and never changes an exact answer.
    ``trace`` and ``audit`` put the engine's per-query ``CascadeTrace`` and
    per-leaf ``FilterAudit`` on the result as numpy dicts; the answers stay
    bitwise the same.  ``device=None`` means the card; the index must live
    there.
    """
    return search_batched_async(
        index, queries, k=k, filter_params=filter_params, leaf_ids=leaf_ids,
        tuner=tuner, quality_target=quality_target, use_filters=use_filters,
        filter_type=filter_type, strategy=strategy, dist_impl=dist_impl,
        bsf_ub=bsf_ub, trace=trace, audit=audit, device=device).result()


def search_batched_grouped(index: FlatIndex, queries,
                           quality_targets: np.ndarray, *, k: int = 1,
                           **kw) -> SearchResult:
    """Per-query quality targets as homogeneous sub-batches: the batch is
    partitioned by unique target (``np.unique`` order), each group goes
    through :func:`search_batched` with its scalar target (``kw``, the
    filter type among them, passed on), and the results
    are stitched back in request order.  The same semantics as passing the
    target array to ``search_batched``; prune decisions tied within an ulp
    of the bsf may differ between the two (the sub-batches run other
    shapes)."""
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    targets = np.asarray(quality_targets, np.float64).reshape(-1)
    Q = queries.shape[0]
    if targets.shape[0] != Q:
        raise ValueError(f"{targets.shape[0]} targets for {Q} queries")
    out: Optional[SearchResult] = None
    for val in np.unique(targets):
        sel = np.where(targets == val)[0]
        r = search_batched(index, queries[sel], k=k,
                           quality_target=float(val), **kw)
        if out is None:
            out = SearchResult(
                dists=np.empty((Q, r.dists.shape[1]), r.dists.dtype),
                ids=np.empty((Q, r.ids.shape[1]), r.ids.dtype),
                searched=np.empty(Q, r.searched.dtype),
                pruned_lb=np.empty(Q, r.pruned_lb.dtype),
                pruned_filter=np.empty(Q, r.pruned_filter.dtype),
                n_leaves=r.n_leaves,
                computed=np.empty(Q, r.computed.dtype))
        out.dists[sel], out.ids[sel] = r.dists, r.ids
        out.searched[sel], out.computed[sel] = r.searched, r.computed
        out.pruned_lb[sel], out.pruned_filter[sel] = (r.pruned_lb,
                                                      r.pruned_filter)
    assert out is not None
    return out


def search_early(index: FlatIndex, query, *, k: int = 1,
                 filter_params=None, leaf_ids: Optional[np.ndarray] = None,
                 tuner: Optional[conformal.AutoTuner] = None,
                 quality_target: Optional[float] = None,
                 use_filters: bool = True, filter_type: str = "mlp",
                 device: Device = None) -> SearchResult:
    """Single-query early-termination search (paper Alg. 2 as written).

    Counters as the reference's: ``searched`` leaves scanned, ``pruned_lb``
    = L − (leaves visited), ``pruned_filter`` visited leaves skipped because
    d_F > bsf.  The visit order is a stable argsort of the lower bounds.
    A scan's distances are sqrt(Σ(s − q)²) over the leaf's rows, summed in
    the early-walk kernel's fixed order (``walk_ref.row_distances``), merged
    into the running top-k stably (ties to the running top-k, then the
    lower row).  ``device=None`` means the card; the index must live there.

    On the card the bounds (``box_lb``), the predictions (the fused filter
    kernel, or the CNN or LSTM kernel), the argsort and the walk (one ``early_walk`` launch) run with
    nothing copied to the host; the ids are mapped through ``index.order``
    there too, and the result comes back in one copy.  On the CPU the walk
    is the plain loop (``walk_ref.early_walk``), one leaf at a time.
    """
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(query, np.float32),
                        device=dev).reshape(1, -1)
    d_lb, d_F = _bounds_and_predictions(index, q, filter_params, leaf_ids,
                                        tuner, quality_target, use_filters,
                                        dev, filter_type)
    lb_row, dF_row = d_lb[0].contiguous(), d_F[0].contiguous()
    order = torch.argsort(lb_row, stable=True)
    args = (index.series, index.leaf_start, index.leaf_size, q[0], lb_row,
            dF_row, order, k)
    if common.on_cpu(*args[:-1]):
        topk_d, topk_i, n_s, n_vis, n_pf = walk_ref.early_walk(*args)
    else:
        topk_d, topk_i, n_s, n_vis, n_pf = walk_kernel.early_walk_cuda(
            *args, index.max_leaf_size)
    ids = torch.where(topk_i >= 0,
                      index.order[topk_i.clamp(0, index.n_series - 1)], -1)
    packed = torch.cat([ids, topk_d.view(torch.int32).to(torch.int64),
                        torch.stack([n_s, n_vis, n_pf]).to(torch.int64)])
    host = packed.cpu().numpy()                    # the one copy
    L = index.n_leaves
    n_s, n_vis, n_pf = host[2 * k:].astype(np.int32)
    return SearchResult(
        dists=host[k:2 * k].astype(np.int32).view(np.float32)[None],
        ids=host[None, :k], searched=np.asarray([n_s], np.int32),
        pruned_lb=np.asarray([L - n_vis], np.int32),
        pruned_filter=np.asarray([n_pf], np.int32), n_leaves=L)
