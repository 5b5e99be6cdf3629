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
  the best-so-far ends the search (every later leaf is prunable too).  The
  reference runs the loop on the device; here the bounds and predictions
  are computed on the card and copied to the host once, and the host makes
  the stop and skip decisions on those float32 values.  The leaves the walk
  may still scan are scored on the card ahead of it, in rounds of 16 that
  double up to 512, one round trip each.

``quality_target=None`` (or ``use_filters=False``) disables the filters and
the search is exact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from . import bounds as bounds_mod
from . import conformal, engine, filters
from .flat_index import FlatIndex
from ..kernels.common import Device, resolve_device

_INF = float("inf")

# leaves search_early scores in its first device round trip, doubling each
# round up to the second number
_EARLY_CHUNK, _EARLY_CHUNK_MAX = 16, 512


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

    @property
    def pruning_ratio(self) -> np.ndarray:
        return 1.0 - self.searched / self.n_leaves


@dataclasses.dataclass
class PendingSearch:
    """A dispatched batched search whose device work may still be running.

    ``done`` is a CUDA event recorded after the engine's last launch (None
    on the CPU); :meth:`result` waits on it and copies to the host.
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
            n_leaves=self.n_leaves, computed=r.n_computed.cpu().numpy())


def predictions_for_all_leaves(index: FlatIndex,
                               filter_params: Optional[Dict[str,
                                                            torch.Tensor]],
                               leaf_ids: np.ndarray, queries: torch.Tensor,
                               offsets: Optional[np.ndarray]) -> torch.Tensor:
    """(Q, L) conformal-adjusted filter lower bounds; −inf ⇒ never prunes.

    ``offsets`` is one (F,) vector shared by the batch, which goes into the
    fused kernel's epilogue, or (Q, F) per-query rows, subtracted from the
    kernel's unadjusted output.
    """
    L = index.n_leaves
    Q = queries.shape[0]
    dev = queries.device
    if filter_params is None or len(leaf_ids) == 0:
        return torch.full((Q, L), -_INF, device=dev)
    off = (None if offsets is None
           else torch.as_tensor(np.asarray(offsets, np.float32), device=dev))
    if off is None or off.dim() == 1:
        preds = filters.apply_mlp_offset(filter_params, queries, off)  # (F, Q)
    else:
        preds = filters.apply_mlp_offset(filter_params, queries) - off.T
    full = torch.full((L, Q), -_INF, device=dev)
    full[torch.as_tensor(np.asarray(leaf_ids), device=dev)] = preds
    return full.T


def _bounds_and_predictions(index: FlatIndex, q: torch.Tensor,
                            filter_params, leaf_ids, tuner, quality_target,
                            use_filters: bool, dev: torch.device):
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
                                            q, offsets)


def search_batched_async(index: FlatIndex, queries, *, k: int = 1,
                         filter_params=None,
                         leaf_ids: Optional[np.ndarray] = None,
                         tuner: Optional[conformal.AutoTuner] = None,
                         quality_target=None, use_filters: bool = True,
                         strategy: str = "auto",
                         dist_impl: Optional[str] = None,
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
                                        dev)
    res = engine.run_cascade(
        index.series, index.leaf_start, index.leaf_size, q, d_lb, d_F,
        k=k, max_leaf=index.max_leaf_size, strategy=strategy,
        dist_impl=dist_impl)
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
                   strategy: str = "auto", dist_impl: Optional[str] = None,
                   device: Device = None) -> SearchResult:
    """Batched LeaFi search; exact when filters are disabled.

    ``quality_target`` is one target for the batch or an array of Q
    per-query targets (lowered to (Q, F) offset rows).  ``strategy`` is
    "compact" (the "auto" default) or "scan"; ``dist_impl`` selects the
    candidate pass (see :func:`engine.run_cascade`).  ``device=None`` means
    the card; the index must live there.
    """
    return search_batched_async(
        index, queries, k=k, filter_params=filter_params, leaf_ids=leaf_ids,
        tuner=tuner, quality_target=quality_target, use_filters=use_filters,
        strategy=strategy, dist_impl=dist_impl, device=device).result()


def search_batched_grouped(index: FlatIndex, queries,
                           quality_targets: np.ndarray, *, k: int = 1,
                           **kw) -> SearchResult:
    """Per-query quality targets as homogeneous sub-batches: the batch is
    partitioned by unique target (``np.unique`` order), each group goes
    through :func:`search_batched` with its scalar target, and the results
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


def _leaf_distances(index: FlatIndex, q: torch.Tensor, leaves: np.ndarray,
                    row_ids: torch.Tensor) -> np.ndarray:
    """(C, max_leaf) distances sqrt(Σ(slab − q)²) of ``q`` to the rows of
    each leaf, rows past the leaf's size +inf, copied to the host."""
    sel = torch.as_tensor(leaves, device=q.device)
    rows = index.leaf_start[sel][:, None] + row_ids               # (C, R)
    diff = index.series[rows] - q
    d = torch.sqrt((diff * diff).sum(dim=-1))
    d = torch.where(row_ids < index.leaf_size[sel][:, None], d, _INF)
    return d.cpu().numpy()


def search_early(index: FlatIndex, query, *, k: int = 1,
                 filter_params=None, leaf_ids: Optional[np.ndarray] = None,
                 tuner: Optional[conformal.AutoTuner] = None,
                 quality_target: Optional[float] = None,
                 use_filters: bool = True,
                 device: Device = None) -> SearchResult:
    """Single-query early-termination search (paper Alg. 2 as written).

    Counters as the reference's: ``searched`` leaves scanned, ``pruned_lb``
    = L − (leaves visited), ``pruned_filter`` visited leaves skipped because
    d_F > bsf.  The visit order is a stable argsort of the lower bounds.
    A scan's distances are sqrt(Σ(slab − q)²) over ``max_leaf`` rows from
    the leaf's start, rows past its size +inf, merged into the running
    top-k with the engine's stable merge (ties to the running top-k).
    ``device=None`` means the card; the index must live there.

    The host walks the visit order on float32 copies of the bounds and
    predictions.  The leaves it may scan next (d_lb ≤ bsf and d_F ≤ bsf at
    the current bsf, which only falls) are scored on the device ahead of
    the walk, ``_EARLY_CHUNK`` at first and twice as many each round (at
    most ``_EARLY_CHUNK_MAX``), one round trip each; a leaf scored but never
    reached costs device work, not a different answer.  A leaf with no distance below the bsf leaves
    the merge unchanged, so it is counted without one.
    """
    dev = resolve_device(device)
    q = torch.as_tensor(np.asarray(query, np.float32),
                        device=dev).reshape(1, -1)
    d_lb, d_F = _bounds_and_predictions(index, q, filter_params, leaf_ids,
                                        tuner, quality_target, use_filters,
                                        dev)
    lb_row = d_lb[0].cpu().numpy()
    order = np.argsort(lb_row, kind="stable")
    lb_ord = lb_row[order]                         # non-decreasing
    dF_ord = d_F[0].cpu().numpy()[order]
    starts = index.leaf_start.cpu().numpy()
    L, R = index.n_leaves, index.max_leaf_size
    row_ids = torch.arange(R, device=dev)
    topk_d = torch.full((1, k), _INF)
    topk_i = torch.full((1, k), -1, dtype=torch.int64)
    bsf = np.float32(_INF)
    n_searched = n_pruned_filter = 0
    chunk, scored, dists = _EARLY_CHUNK, 0, {}
    p = 0
    while p < L and lb_ord[p] <= bsf:
        if dF_ord[p] > bsf:
            n_pruned_filter += 1
            p += 1
            continue
        if p >= scored:        # score the next leaves the walk may scan
            stop = int(np.searchsorted(lb_ord, bsf, side="right"))
            pos = p + np.flatnonzero(dF_ord[p:stop] <= bsf)[:chunk]
            scored = int(pos[-1]) + 1 if len(pos) == chunk else stop
            dists = dict(zip(pos.tolist(), _leaf_distances(
                index, q, order[pos], row_ids)))
            chunk = min(2 * chunk, _EARLY_CHUNK_MAX)
        d = dists.pop(p)
        if d.min() < bsf:
            start = int(starts[order[p]])
            topk_d, topk_i = engine._merge_topk(
                topk_d, topk_i, torch.from_numpy(d)[None],
                torch.arange(start, start + R)[None], k)
            bsf = topk_d[0, -1].numpy()
        n_searched += 1
        p += 1
    ids = torch.as_tensor(topk_i, device=dev)
    orig = torch.where(ids >= 0, index.order[ids.clamp(0, index.n_series - 1)],
                       -1)
    return SearchResult(
        dists=topk_d.numpy(), ids=orig.cpu().numpy(),
        searched=np.asarray([n_searched], np.int32),
        pruned_lb=np.asarray([L - p], np.int32),
        pruned_filter=np.asarray([n_pruned_filter], np.int32),
        n_leaves=L)
